// The features stage's md5-seeded window sample for sm_90a: for each
// (recording, band) lane, the K windows of the reference's
//   np.random.default_rng(int(md5(f"{stem}-{band}-{seed}").hexdigest()[:8], 16))
//     .choice(nw, size=min(K, nw), replace=False)
// (scripts/tda_eeg_classification_v2.py:394-400), bit for bit, one thread a
// lane, and the bank's paired comparison columns beside them.
//
// Replaces no Pallas kernel.  The JAX package draws the sample on the host
// (`tda_eeg_audio_tpu/models/classify.py:48` `window_sample_indices`), as the
// port's CPU path does (`io/synthetic.window_sample_indices`, the
// specification): a NumPy generator a lane, 7,200 a study, whose seeding
// (SeedSequence + PCG64) is most of the host's 0.3 s a job while the card
// waits.  Each thread runs the whole chain in registers:
//   1. MD5 of the message stem + suffix (the band's "-{band}-{seed}"), as
//      many 64-byte blocks as it needs; the seed e is the digest's first four
//      bytes read big-endian;
//   2. NumPy's SeedSequence(e): a pool of 4 words hashed and mixed, then
//      generate_state(4, uint64);
//   3. PCG64 (XSL-RR over a 128-bit LCG), state (s0 << 64 | s1), stream
//      (s2 << 64 | s3), seeded as pcg_setseq_128_srandom_r; 128-bit products
//      from 64-bit multiplies and __umul64hi;
//   4. next_uint32: the low half of a 64-bit draw, then its buffered high
//      half;
//   5. Floyd's algorithm for j in [nw - k, nw): v = Lemire's bounded draw in
//      [0, j] (random_bounded_uint64 with use_masked false), j instead where
//      v was drawn before; membership is a bitmap over nw bits in shared
//      memory (NumPy's hash set holds the same set);
//   6. Fisher-Yates over the k results, i = k - 1 .. 1, j a Lemire draw in
//      [0, i] (Generator._shuffle_int).
// NumPy's other branch (a tail shuffle) starts at nw > 10,000; MAX_NW keeps
// every launch below it.
//
// Columns of a lane's row (Kx = K, or K + the bank's paired columns):
//   [0, k)   the draw (or arange in "first" mode), mask 1;
//   [k, K)   0, mask 0;
//   [K, Kx)  the comparison's paired windows over n_pair windows, mask 0:
//            min(c, max(n_pair - 1, 0)) where n_pair <= Kx - K, else
//            trunc(float(c) * float(n_pair - 1) / float(Kx - K - 1)) in
//            float32, rounded a step at a time as NumPy's float32 does.
//
// What bounds it: latency.  A lane is ~80 dependent PCG64 steps (each a
// 64 x 64 -> 128-bit product and a few adds), one or two MD5 blocks of 64
// dependent rounds and ~40 dependent shared-memory bitmap tests: tens of
// microseconds for the study's 7,200 lanes.  Its bytes (a batch's
// (B, 5, Kx) indices and mask written once, ~0.1 MB) take ~0.03 us at
// 3.35 TB/s; the work itself is ~1e7 integer operations, under a
// microsecond at the card's rate.  One launch a batch, nothing in front
// of it: the stems, window counts and paired counts are tables uploaded once
// a features stage and read at a row offset.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwindow_sample.so window_sample.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;           // lanes a block
constexpr int N_BANDS = 5;
constexpr int MAX_NW = 4096;          // windows a recording: bitmap bits a lane
constexpr int MAP_WORDS = MAX_NW / 32;

// MD5 (RFC 1321): initial state and the sine table
constexpr uint32_t MD5_A0 = 0x67452301u;
constexpr uint32_t MD5_B0 = 0xefcdab89u;
constexpr uint32_t MD5_C0 = 0x98badcfeu;
constexpr uint32_t MD5_D0 = 0x10325476u;
__constant__ uint32_t MD5_K[64] = {
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu, 0xf57c0fafu, 0x4787c62au,
    0xa8304613u, 0xfd469501u, 0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
    0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u, 0xf61e2562u, 0xc040b340u,
    0x265e5a51u, 0xe9b6c7aau, 0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
    0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu, 0xa9e3e905u, 0xfcefa3f8u,
    0x676f02d9u, 0x8d2a4c8au, 0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
    0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u, 0x289b7ec6u, 0xeaa127fau,
    0xd4ef3085u, 0x04881d05u, 0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
    0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u, 0x655b59c3u, 0x8f0ccc92u,
    0xffeff47du, 0x85845dd1u, 0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u};

// NumPy's SeedSequence (numpy/random/bit_generator.pyx)
constexpr uint32_t SS_INIT_A = 0x43b0d7e5u;
constexpr uint32_t SS_MULT_A = 0x931e8875u;
constexpr uint32_t SS_INIT_B = 0x8b51f9ddu;
constexpr uint32_t SS_MULT_B = 0x58f38dedu;
constexpr uint32_t SS_MIX_MULT_L = 0xca01f9ddu;
constexpr uint32_t SS_MIX_MULT_R = 0x4973f715u;
constexpr int SS_POOL = 4;

// PCG64's 128-bit LCG multiplier (numpy/random/src/pcg64/pcg64.h)
constexpr unsigned long long PCG_MULT_HI = 2549297995355413924ULL;
constexpr unsigned long long PCG_MULT_LO = 4865540595714422341ULL;

struct Args {
  const uint8_t* text;  // (n_rec + 5, width): the stems, then the band suffixes
  const int* ints;      // (n_rec + 5, 3): byte length, nw, n_pair
  int width, n_rec, row0, B, K, Kx, first;
  long long* idx;       // (B, 5, Kx)
  uint8_t* mask;        // (B, 5, Kx)
};

__device__ __forceinline__ int md5_shift(int i) {
  const int t = i & 3;
  switch (i >> 4) {
    case 0: return t == 0 ? 7 : t == 1 ? 12 : t == 2 ? 17 : 22;
    case 1: return t == 0 ? 5 : t == 1 ? 9 : t == 2 ? 14 : 20;
    case 2: return t == 0 ? 4 : t == 1 ? 11 : t == 2 ? 16 : 23;
    default: return t == 0 ? 6 : t == 1 ? 10 : t == 2 ? 15 : 21;
  }
}

// The digest's first four bytes, big-endian, of the message stem[0, n1) +
// suffix[0, n2): hexdigest()[:8] read as an integer.
__device__ uint32_t md5_seed(const uint8_t* stem, int n1, const uint8_t* suffix, int n2) {
  const int L = n1 + n2;
  const int blocks = (L + 8) / 64 + 1;
  uint32_t h0 = MD5_A0, h1 = MD5_B0, h2 = MD5_C0, h3 = MD5_D0;
  for (int blk = 0; blk < blocks; ++blk) {
    uint32_t M[16];
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      uint32_t v = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = blk * 64 + w * 4 + q;
        const uint32_t c = p < n1 ? stem[p] : p < L ? suffix[p - n1] : p == L ? 0x80u : 0u;
        v |= c << (8 * q);
      }
      M[w] = v;
    }
    if (blk == blocks - 1) {  // the message's length in bits, little-endian
      const unsigned long long bits = 8ULL * (unsigned long long)L;
      M[14] = (uint32_t)bits;
      M[15] = (uint32_t)(bits >> 32);
    }
    uint32_t a = h0, b = h1, c = h2, d = h3;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      uint32_t f;
      int g;
      if (i < 16) {
        f = (b & c) | (~b & d);
        g = i;
      } else if (i < 32) {
        f = (d & b) | (~d & c);
        g = (5 * i + 1) & 15;
      } else if (i < 48) {
        f = b ^ c ^ d;
        g = (3 * i + 5) & 15;
      } else {
        f = c ^ (b | ~d);
        g = (7 * i) & 15;
      }
      f += a + MD5_K[i] + M[g];
      a = d;
      d = c;
      c = b;
      b += __funnelshift_l(f, f, md5_shift(i));
    }
    h0 += a;
    h1 += b;
    h2 += c;
    h3 += d;
  }
  return __byte_perm(h0, 0, 0x0123);
}

struct Pcg {
  unsigned long long hi, lo;          // state
  unsigned long long inc_hi, inc_lo;  // stream (odd)
  uint32_t buf;                       // the buffered high half
  bool has;
};

__device__ __forceinline__ void pcg_step(Pcg& g) {
  const unsigned long long lo = g.lo * PCG_MULT_LO;
  unsigned long long hi = __umul64hi(g.lo, PCG_MULT_LO) + g.lo * PCG_MULT_HI + g.hi * PCG_MULT_LO;
  const unsigned long long lo2 = lo + g.inc_lo;
  hi += g.inc_hi + (lo2 < lo ? 1ULL : 0ULL);
  g.hi = hi;
  g.lo = lo2;
}

__device__ __forceinline__ uint32_t ss_hashmix(uint32_t v, uint32_t& hc) {
  v ^= hc;
  hc *= SS_MULT_A;
  v *= hc;
  return v ^ (v >> 16);
}

__device__ __forceinline__ uint32_t ss_mix(uint32_t x, uint32_t y) {
  const uint32_t r = SS_MIX_MULT_L * x - SS_MIX_MULT_R * y;
  return r ^ (r >> 16);
}

// default_rng(e) for 0 <= e < 2^32: SeedSequence(e).generate_state(4,
// uint64) seeds PCG64.
__device__ Pcg pcg_seeded(uint32_t e) {
  uint32_t pool[SS_POOL];
  uint32_t hc = SS_INIT_A;
#pragma unroll
  for (int i = 0; i < SS_POOL; ++i) pool[i] = ss_hashmix(i == 0 ? e : 0u, hc);
#pragma unroll
  for (int s = 0; s < SS_POOL; ++s)
#pragma unroll
    for (int d = 0; d < SS_POOL; ++d)
      if (s != d) pool[d] = ss_mix(pool[d], ss_hashmix(pool[s], hc));
  uint32_t st[8];
  uint32_t hb = SS_INIT_B;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t v = pool[i % SS_POOL] ^ hb;
    hb *= SS_MULT_B;
    v *= hb;
    st[i] = v ^ (v >> 16);
  }
  unsigned long long w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = (unsigned long long)st[2 * k] | ((unsigned long long)st[2 * k + 1] << 32);
  // pcg_setseq_128_srandom_r(initstate = w0:w1, initseq = w2:w3)
  Pcg g;
  g.inc_hi = (w[2] << 1) | (w[3] >> 63);
  g.inc_lo = (w[3] << 1) | 1ULL;
  g.hi = 0;
  g.lo = 0;
  pcg_step(g);
  const unsigned long long lo = g.lo + w[1];
  g.hi += w[0] + (lo < g.lo ? 1ULL : 0ULL);
  g.lo = lo;
  pcg_step(g);
  g.has = false;
  g.buf = 0;
  return g;
}

__device__ __forceinline__ uint32_t next_uint32(Pcg& g) {
  if (g.has) {
    g.has = false;
    return g.buf;
  }
  pcg_step(g);
  const unsigned long long x = g.hi ^ g.lo;  // XSL-RR
  const unsigned r = (unsigned)(g.hi >> 58);
  const unsigned long long out = (x >> r) | (x << ((64u - r) & 63u));
  g.has = true;
  g.buf = (uint32_t)(out >> 32);
  return (uint32_t)out;
}

// random_bounded_uint64(0, rng, use_masked=false) for rng < 2^32 - 1:
// Lemire's multiply with rejection (buffered_bounded_lemire_uint32).
__device__ __forceinline__ uint32_t bounded(Pcg& g, uint32_t rng) {
  if (rng == 0) return 0;
  const uint32_t ex = rng + 1;
  unsigned long long m = (unsigned long long)next_uint32(g) * ex;
  uint32_t left = (uint32_t)m;
  if (left < ex) {
    const uint32_t threshold = (0xFFFFFFFFu - rng) % ex;
    while (left < threshold) {
      m = (unsigned long long)next_uint32(g) * ex;
      left = (uint32_t)m;
    }
  }
  return (uint32_t)(m >> 32);
}

__global__ void __launch_bounds__(THREADS) window_sample_kernel(Args a) {
  __shared__ uint32_t seen[MAP_WORDS][THREADS];
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= a.B * N_BANDS) return;
  const int band = lane % N_BANDS;
  const int r = a.row0 + lane / N_BANDS;
  const int nw = a.ints[3 * r + 1];
  const int n_pair = a.ints[3 * r + 2];
  long long* out = a.idx + (long long)lane * a.Kx;
  uint8_t* m = a.mask + (long long)lane * a.Kx;
  if (nw < 0 || nw > MAX_NW) {  // outside the plan (the launcher raises first): -1, unmasked
    for (int c = 0; c < a.Kx; ++c) {
      out[c] = -1;
      m[c] = 0;
    }
    return;
  }
  const int k = min(a.K, nw);
  if (a.first) {
    for (int c = 0; c < k; ++c) out[c] = c;
  } else {
    const int sr = a.n_rec + band;
    const uint32_t e = md5_seed(a.text + (long long)r * a.width, a.ints[3 * r],
                                a.text + (long long)sr * a.width, a.ints[3 * sr]);
    Pcg g = pcg_seeded(e);
    const int words = (nw + 31) >> 5;
    for (int w = 0; w < words; ++w) seen[w][threadIdx.x] = 0u;
    for (int j = nw - k; j < nw; ++j) {  // Floyd
      uint32_t v = bounded(g, (uint32_t)j);
      if (seen[v >> 5][threadIdx.x] & (1u << (v & 31))) v = (uint32_t)j;
      seen[v >> 5][threadIdx.x] |= 1u << (v & 31);
      out[j - (nw - k)] = v;
    }
    for (int i = k - 1; i > 0; --i) {  // Fisher-Yates
      const uint32_t j = bounded(g, (uint32_t)i);
      const long long t = out[j];
      out[j] = out[i];
      out[i] = t;
    }
  }
  for (int c = 0; c < k; ++c) m[c] = 1;
  for (int c = k; c < a.K; ++c) {
    out[c] = 0;
    m[c] = 0;
  }
  const int n_cmp = a.Kx - a.K;
  for (int c = 0; c < n_cmp; ++c) {
    long long v;
    if (n_pair <= n_cmp) {
      v = min(c, max(n_pair - 1, 0));
    } else {
      v = (long long)__fdiv_rn(__fmul_rn((float)c, (float)(n_pair - 1)), (float)(n_cmp - 1));
    }
    out[a.K + c] = v;
    m[a.K + c] = 0;
  }
}

}  // namespace

// What the library was built with: threads a block, MAX_NW, static shared
// bytes, registers, local bytes, blocks an SM.
extern "C" int window_sample_layout(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, window_sample_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, window_sample_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = THREADS;
  out[1] = MAX_NW;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = blocks;
  return 0;
}

// One call: rows [row0, row0 + B) of the tables, each nw in [0, MAX_NW],
// 1 <= K <= Kx, Kx - K != 1; first != 0 takes the first windows.  One
// launch on `stream`; returns the cudaError_t of the launch.
extern "C" int window_sample_launch(const uint8_t* text, const int* ints, int width, int n_rec,
                                    int row0, int B, int K, int Kx, int first, long long* idx,
                                    uint8_t* mask, void* stream) {
  if (B < 1 || K < 1 || Kx < K || Kx - K == 1 || row0 < 0 || row0 + B > n_rec)
    return (int)cudaErrorInvalidValue;
  const Args a{text, ints, width, n_rec, row0, B, K, Kx, first, idx, mask};
  const int grid = (B * N_BANDS + THREADS - 1) / THREADS;
  window_sample_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
