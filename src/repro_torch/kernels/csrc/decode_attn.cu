// Flash-decode GQA attention over an FRSZ2-coded KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/decode_attn.py::decode_attn`
// (pallas_call at :85): out[b, h] = softmax(q[b, h] . K[b, h/G, :len_b]^T *
// sm_scale) . V[b, h/G, :len_b], with K and V decoded from their codes and
// block exponents in registers, accumulated in f32, returned in q's dtype.
// Positions >= lengths[b] contribute nothing; a row with none divides by 1.
//
// What bounds it on this card: bytes.  Each valid cache position is read
// once per kv head as D codes plus its exponents, for K and for V: 2 * (256 +
// 1) B at D = 128, l = 16.  The G query heads that share a kv head reuse each
// decoded position, so the FMAs (4 * G * D per position) are far under the
// f32 rate.  What costs beyond the bytes is issue: the first design (one
// position a warp at a time, the bit decode, a shuffle butterfly and two
// exponentials per query head and position: 500 warp instructions a
// position) ran at 6.6x its byte bound, 67-69 us at the serving shape (B 8,
// Hkv 4, G 8, S 2120) and 471-474 us at S = 32768.
//
// What the design does about it (147 warp instructions a position; 31-32 us
// and 177 us at those shapes, 3.1x and 2.0x the bound; H100 80GB HBM3,
// 700 W):
// - flash-decoding, as before: one block of four warps per (S-split, kv
//   head, group tile of <= 8 query heads, sequence), so B * Hkv * splits
//   blocks fill the 132 SMs even at B * Hkv = 32; a block whose split lies
//   wholly past lengths[b] writes an empty partial and exits; a second small
//   kernel merges the splits.  The split (whole tiles, the fewest that fit
//   the grid into one wave of resident blocks, at most 8 tiles; the blocks
//   an SM holds come from decode_attn_occupancy) is a function of the
//   shapes only, so the launch needs no host read;
// - a split walks its positions in tiles of T = 64: the tile's K and V codes
//   (16-byte aligned caches) and exponents go to shared memory by cp.async,
//   the next tile's copies in flight while this one is computed (two
//   stages, ~33 KB a stage at D = 128, l = 16; K rows padded by one chunk of
//   8 codes so that the logits' reads are free of bank conflicts);
// - logits: two threads per position, each a half of D, dot the position's
//   codes with all the tile's query heads (q in shared memory, read as
//   broadcasts), so each code is decoded once for all G heads; the halves
//   meet by one shuffle a head;
// - the decode is the exact scaled decode (frsz2_common.cuh), split in two:
//   the significand +-csig as a float by a mask and one FADD (2^23 + csig
//   read from bits, minus 2^23: no I2F, which issues at a quarter of the FMA
//   rate), and the block's power of two, applied once per K position to its
//   logits and once per V code.  A position whose block lies outside
//   [l-1, 2*bias], or a cache with more than one block a row (bs < D), takes
//   the guarded decode (decode_bits out of line) instead;
// - softmax: one warp per query head reduces the tile's 64 logits: one max,
//   one rescale of the running state and 64 exponentials a head and tile,
//   the probabilities left in shared memory;
// - P . V: each thread owns 4 columns of d for all the tile's heads (32 f32
//   accumulators at G = 8) and walks a quarter of the tile's positions,
//   decoding each V code once; the quarters are summed once per split.
// Softmax runs in base 2 (logits pre-scaled by log2 e, exp2f), which is the
// same function.  FP32 CUDA cores, not tensor cores: a 16-bit code carries a
// 15-bit significand, which neither bf16 nor tf32 holds exactly.
//
// Head widths: D = 64, 112 (zamba2-7b's) and 128.  D = 112 is no power of
// two: its rows are 14 chunks of 8 codes (224 or 112 bytes, still whole
// 16-byte copies), P.V's 28 column quads leave 16 of the 128 threads idle,
// and its cache holds one block a row (nbd = 1, bs = D), so every code's
// exponent is the row's first.
//
// Layouts (row-major):
//   q        (B, Hkv, G, D)         f32 or bf16
//   k/v codes (B, Hkv, S, D)        uint8 (l = 8) or uint16 (l = 16) patterns
//   k/v exps (B, Hkv, S, nbd)       uint8 block max exponents, D = nbd * bs
//   lengths  (B,)                   int32
//   part_acc (B, Hkv, G, nsplit, D) f32 scratch; part_ml (.., nsplit, 2)
//   out      (B, Hkv, G, D)         q's dtype
#include <cmath>

#include <cuda_bf16.h>

#include "frsz2_common.cuh"

namespace frsz2 {
namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                     // positions a tile (T)
constexpr int kPvCols = 4;                    // P.V: columns of d a thread owns
static_assert(kPvCols == 4, "a thread's P.V columns are one float4 and one Quad of codes");
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kMagic = 0x4B000000u;      // 2^23 as a float's bits
constexpr float kMagicF = 8388608.0f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A chunk of 8 codes (16 or 8 bytes) and a quad of 4 (8 or 4 bytes).
template <typename CodeT>
struct Words;
template <>
struct Words<unsigned short> {
  using Chunk = uint4;
  using Quad = uint2;
};
template <>
struct Words<unsigned char> {
  using Chunk = uint2;
  using Quad = unsigned;
};

// The significand field csig (bits [pos, pos + LB - 1) of w) as an exact
// float, and the sign bit (bit pos + LB - 1) on it: +-csig, the scaled
// decode's value before its multiply by the block's power of two.
template <int LB, int POS>
__device__ __forceinline__ float signed_sig(unsigned w) {
  constexpr unsigned kMask = (1u << (LB - 1)) - 1u;
  const float m = __fsub_rn(__uint_as_float(((w >> POS) & kMask) | kMagic), kMagicF);
  constexpr int kUp = 32 - POS - LB;          // moves the sign bit to bit 31
  return __uint_as_float(__float_as_uint(m) | ((w << kUp) & 0x80000000u));
}

// The codes of a 32-bit word, in order.
template <typename CodeT>
__device__ __forceinline__ void word_sigs(unsigned w, float* f) {
  if constexpr (sizeof(CodeT) == 2) {
    f[0] = signed_sig<16, 0>(w);
    f[1] = signed_sig<16, 16>(w);
  } else {
    f[0] = signed_sig<8, 0>(w);
    f[1] = signed_sig<8, 8>(w);
    f[2] = signed_sig<8, 16>(w);
    f[3] = signed_sig<8, 24>(w);
  }
}

template <typename CodeT, typename Wd, int N>
__device__ __forceinline__ void sigs(Wd w, float (&f)[N]) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(CodeT));   // codes a word
  const unsigned* u = reinterpret_cast<const unsigned*>(&w);
#pragma unroll
  for (int i = 0; i < N / kPer; ++i) word_sigs<CodeT>(u[i], f + i * kPer);
}

template <int N>
struct Vals {
  float v[N];
};

// The guarded decode of N consecutive codes starting at column d0, each with
// its own block's exponent from erow: the rare path (a block outside the
// scaled decode's range, or bs < D), out of line.
template <typename CodeT, int N, typename Wd>
__device__ __noinline__ Vals<N> decode_slow(Wd w, const unsigned char* erow, int d0,
                                           int bs_log2) {
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));
  union {
    Wd w;
    CodeT c[N];
  } u;
  u.w = w;
  Vals<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i)
    r.v[i] = decode_scaled<F32, LB>(static_cast<unsigned>(u.c[i]), erow[(d0 + i) >> bs_log2]);
  return r;
}

// dot[g] += q[g, c*8 .. c*8+8) . f for each head of the tile (q in shared
// memory, rows of D floats; every lane of a half-warp reads the same words).
template <int D, int GT>
__device__ __forceinline__ void dot_chunk(float (&dot)[GT], const float (&f)[8],
                                          const float* qc) {
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const float4 a = *reinterpret_cast<const float4*>(qc + g * D);
    const float4 b = *reinterpret_cast<const float4*>(qc + g * D + 4);
    float s = dot[g];
    s = fmaf(a.x, f[0], s);
    s = fmaf(a.y, f[1], s);
    s = fmaf(a.z, f[2], s);
    s = fmaf(a.w, f[3], s);
    s = fmaf(b.x, f[4], s);
    s = fmaf(b.y, f[5], s);
    s = fmaf(b.z, f[6], s);
    s = fmaf(b.w, f[7], s);
    dot[g] = s;
  }
}

// Shared-memory geometry of one instantiation; nbd (exponents a row) is the
// only runtime part.
template <typename CodeT, int D, int GT>
struct Geom {
  static constexpr int RB = D * static_cast<int>(sizeof(CodeT));   // code row bytes
  static constexpr int CB = 8 * static_cast<int>(sizeof(CodeT));   // chunk bytes
  static constexpr int RSK = RB + CB;          // K row stride: one chunk of padding
  static constexpr int DQ = D / kPvCols;       // P.V: column quads
  static constexpr int TP = kThreads / DQ;     // P.V: position lanes
  static constexpr int PVT = TP * DQ;          // P.V: threads that own columns
  static constexpr int RED = TP * GT * D * 4;  // the split's closing sum
  __host__ __device__ static int exp_bytes(int nbd) { return (kTile * nbd + 8 + 15) / 16 * 16; }
  __host__ __device__ static int stage_bytes(int nbd) {
    return kTile * RSK + kTile * RB + 2 * exp_bytes(nbd);
  }
  __host__ __device__ static int ring_bytes(int nbd) {
    return 2 * stage_bytes(nbd) > RED ? 2 * stage_bytes(nbd) : RED;
  }
  __host__ __device__ static int smem_bytes(int nbd) {
    return ring_bytes(nbd) + (GT * D + kTile * GT + 2 * kTile + 8) * 4;
  }
};

template <typename QT, typename CodeT, int D, int GT>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const QT* __restrict__ q, const CodeT* __restrict__ kc,
                 const unsigned char* __restrict__ ke, const CodeT* __restrict__ vc,
                 const unsigned char* __restrict__ ve, const int* __restrict__ lengths,
                 float* __restrict__ part_acc, float* __restrict__ part_ml, int Hkv,
                 int G, int S, int nbd, int bs_log2, int chunk, int nsplit,
                 float scale_log2) {
  using Gm = Geom<CodeT, D, GT>;
  using Chunk = typename Words<CodeT>::Chunk;
  using Quad = typename Words<CodeT>::Quad;
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));
  constexpr int RB = Gm::RB, CB = Gm::CB, RSK = Gm::RSK, DQ = Gm::DQ, TP = Gm::TP;
  constexpr int HCH = D / 16;                  // chunks of a half row
  constexpr int GPW = (GT + kWarps - 1) / kWarps;   // heads a softmax warp owns
  extern __shared__ __align__(16) unsigned char smem[];

  const int gtiles = (G + GT - 1) / GT;
  const int split = blockIdx.x;
  const int h = blockIdx.y / gtiles;
  const int g0 = (blockIdx.y % gtiles) * GT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int len = min(max(lengths[b], 0), S);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const long long bh = static_cast<long long>(b) * Hkv + h;
  const int glive = min(GT, G - g0);

  if (s0 >= s1) {  // no valid position in this split: an empty partial
    for (int i = tid; i < glive * D; i += kThreads) {
      const long long o = (bh * G + g0 + i / D) * nsplit + split;
      part_acc[o * D + i % D] = 0.f;
      if (i % D == 0) {
        part_ml[2 * o] = -INFINITY;
        part_ml[2 * o + 1] = 0.f;
      }
    }
    return;
  }

  const int SB = Gm::stage_bytes(nbd);
  const int EB = Gm::exp_bytes(nbd);
  float* qs = reinterpret_cast<float*>(smem + Gm::ring_bytes(nbd));   // (GT, D)
  float* sp = qs + GT * D;              // (T, GT): logits, then probabilities
  float* ks = sp + kTile * GT;          // (T,) a K position's logit scale
  float* vsc = ks + kTile;              // (T,) a V position's block scale, 0: guarded
  float* alpha = vsc + kTile;           // (GT,) the tile's rescale of the state

  // The tile from position ts into stage `st`: codes by cp.async (the
  // caches start 16-byte aligned: the wrapper checks), exponents as the
  // aligned 4-byte words that cover them (a word holding a valid byte lies
  // inside the allocation).
  auto issue = [&](int ts, int st) {
    const int nv = min(kTile, s1 - ts);
    unsigned char* kd = smem + st * SB;
    unsigned char* vd = kd + kTile * RSK;
    const long long row0 = bh * S + ts;
    // K rows go to padded rows a chunk at a time (at l = 8 a padded row is
    // 8-byte aligned only); V rows are contiguous
    constexpr int kCpr = RB / CB;
    const unsigned char* gk = reinterpret_cast<const unsigned char*>(kc + row0 * D);
    const unsigned char* gv = reinterpret_cast<const unsigned char*>(vc + row0 * D);
    for (int i = tid; i < nv * kCpr; i += kThreads) {
      const int r = i / kCpr;
      const int c = (i % kCpr) * CB;
      cp_async_word<CB>(kd + r * RSK + c, gk + r * RB + c);
    }
    for (int i = tid; i < nv * (RB / 16); i += kThreads) cp_async16(vd + i * 16, gv + i * 16);
    unsigned char* ed = vd + kTile * RB;
    const unsigned char* src[2] = {ke + row0 * nbd, ve + row0 * nbd};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(src[k]);
      const uintptr_t w0 = a0 & ~uintptr_t(3);
      const int nw = static_cast<int>((a0 + static_cast<uintptr_t>(nv) * nbd - w0 + 3) >> 2);
      for (int i = tid; i < nw; i += kThreads)
        cp_async_word<4>(ed + k * EB + 4 * i, reinterpret_cast<const void*>(w0 + 4 * i));
    }
  };
  // byte offset of a tile's first exponent inside its first staged word
  auto exp_off = [&](const unsigned char* e, int ts) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(e + (bh * S + ts) * nbd) & 3);
  };

  // the first tile's copies go out before q is read (the first wait covers
  // both)
  issue(s0, 0);
  cp_async_commit();
  for (int i = tid; i < GT * D; i += kThreads) {
    const int g = i / D;
    qs[i] = g < glive ? to_f32(q[(bh * G + g0 + g) * D + i % D]) : 0.f;
  }
  float m_run[GPW], l_run[GPW];
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  float acc[GT][kPvCols];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int i = 0; i < kPvCols; ++i) acc[g][i] = 0.f;

  const int dq = tid % DQ;
  const int tp = tid / DQ;
  // a thread past TP * DQ (D = 112: 16 of them) owns no P.V column
  const bool pv = tid < Gm::PVT;
  const int ntiles = (s1 - s0 + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    const int ts = s0 + it * kTile;
    const int nv = min(kTile, s1 - ts);
    cp_async_wait<0>();
    __syncthreads();  // this tile is in; every thread is done with the last one
    if (it + 1 < ntiles) issue(ts + kTile, (it + 1) & 1);
    cp_async_commit();
    const unsigned char* kt = smem + (it & 1) * SB;
    const unsigned char* vt = kt + kTile * RSK;
    const unsigned char* ket = vt + kTile * RB + exp_off(ke, ts);
    const unsigned char* vet = vt + kTile * RB + EB + exp_off(ve, ts);

    // logits: position t of the tile, half hh of its row
    {
      const int t = (warp << 4) | (lane & 15);
      const int hh = lane >> 4;
      float dot[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) dot[g] = 0.f;
      float kscale = 0.f;
      if (t < nv) {
        const unsigned char* krow = kt + t * RSK;
        const unsigned char* erow = ket + t * nbd;
        const int e = erow[0];
        if (nbd == 1 && scaled_in_range<F32, LB>(e)) {
#pragma unroll
          for (int j = 0; j < HCH; ++j) {
            const int c = hh * HCH + j;
            float f[8];
            sigs<CodeT>(*reinterpret_cast<const Chunk*>(krow + c * CB), f);
            dot_chunk<D, GT>(dot, f, qs + c * 8);
          }
          kscale = __uint_as_float(scale_hi<F32, LB>(e)) * scale_log2;
        } else {
#pragma unroll 1
          for (int j = 0; j < HCH; ++j) {
            const int c = hh * HCH + j;
            const Vals<8> f = decode_slow<CodeT, 8>(
                *reinterpret_cast<const Chunk*>(krow + c * CB), erow, c * 8, bs_log2);
            dot_chunk<D, GT>(dot, f.v, qs + c * 8);
          }
          kscale = scale_log2;
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 16);
      if (hh == 0) {
#pragma unroll
        for (int g = 0; g < GT; ++g) sp[t * GT + g] = t < nv ? dot[g] * kscale : -INFINITY;
      } else if (t < nv) {
        const unsigned char* erow = vet + t * nbd;
        const int e = erow[0];
        vsc[t] = nbd == 1 && scaled_in_range<F32, LB>(e)
                     ? __uint_as_float(scale_hi<F32, LB>(e))
                     : 0.f;
      }
    }
    __syncthreads();

    // softmax over the tile: one warp per query head (lanes: positions
    // lane and lane + 32); the tile's first position is valid, so its
    // max is finite
#pragma unroll
    for (int i = 0; i < GPW; ++i) {
      const int g = warp + i * kWarps;
      if (g < GT) {
        const float a = sp[lane * GT + g];
        const float c = sp[(lane + 32) * GT + g];
        float mt = fmaxf(a, c);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m_run[i], mt);
        const float al = exp2f(m_run[i] - m_new);    // 0 on the first tile
        const float pa = exp2f(a - m_new);
        const float pc = exp2f(c - m_new);
        sp[lane * GT + g] = pa;
        sp[(lane + 32) * GT + g] = pc;
        float ps = pa + pc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_run[i] = fmaf(l_run[i], al, ps);
        m_run[i] = m_new;
        if (lane == 0) alpha[g] = al;
      }
    }
    __syncthreads();

    // P . V: columns dq*kPvCols .. of every head, positions tp, tp + TP, ...
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float al = alpha[g];
#pragma unroll
      for (int i = 0; i < kPvCols; ++i) acc[g][i] *= al;
    }
#pragma unroll 1
    for (int t = pv ? tp : nv; t < nv; t += TP) {
      const Quad w = *reinterpret_cast<const Quad*>(vt + t * RB + dq * kPvCols * sizeof(CodeT));
      const float sc = vsc[t];
      float v[kPvCols];
      if (sc != 0.f) {
        sigs<CodeT>(w, v);
#pragma unroll
        for (int i = 0; i < kPvCols; ++i) v[i] = __fmul_rn(v[i], sc);
      } else {
        const Vals<kPvCols> r = decode_slow<CodeT, kPvCols>(w, vet + t * nbd, dq * kPvCols, bs_log2);
#pragma unroll
        for (int i = 0; i < kPvCols; ++i) v[i] = r.v[i];
      }
      float p[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) p[g] = sp[t * GT + g];
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int i = 0; i < kPvCols; ++i) acc[g][i] = fmaf(p[g], v[i], acc[g][i]);
    }
  }

  // close the split: the position lanes' sums, then one partial per head
  __syncthreads();  // the ring is free
  float* red = reinterpret_cast<float*>(smem);     // (TP, GT, D)
  if (pv) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
      *reinterpret_cast<float4*>(red + (tp * GT + g) * D + dq * kPvCols) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    const int g = warp + i * kWarps;
    if (g < glive && lane == 0) {
      const long long o = (bh * G + g0 + g) * nsplit + split;
      part_ml[2 * o] = m_run[i];
      part_ml[2 * o + 1] = l_run[i];
    }
  }
  __syncthreads();
  for (int i = tid; i < glive * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float A = 0.f;
#pragma unroll
    for (int r = 0; r < TP; ++r) A += red[(r * GT + g) * D + d];
    part_acc[((bh * G + g0 + g) * nsplit + split) * D + d] = A;
  }
}

// Block-wide max or sum over the threads of a merge block (whole warps);
// every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // red may still be read from the previous reduction
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < nw; ++w) v = MAX ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// One block per (b, query head), D threads rounded up to whole warps (the
// reductions shuffle over full warps): merge the splits' partials.  The
// splits' weights exp2(m_s - M) are formed once, in shared memory (nsplit
// floats, dynamic), by the block's threads together; then each thread
// d < D sums its column over the splits, the loads independent of each
// other.
template <typename QT>
__global__ void merge_kernel(const float* __restrict__ part_acc,
                             const float* __restrict__ part_ml, QT* __restrict__ out,
                             int nsplit, int D) {
  extern __shared__ float wts[];
  __shared__ float red[4];
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const int nt = blockDim.x;
  const float* ml = part_ml + 2 * row * nsplit;
  float M = -INFINITY;
  for (int s = d; s < nsplit; s += nt) M = fmaxf(M, ml[2 * s]);
  M = block_reduce<true>(M, red);
  float Ls = 0.f;
  for (int s = d; s < nsplit; s += nt) {
    const float ms = ml[2 * s];
    const float f = ms == -INFINITY ? 0.f : exp2f(ms - M);
    wts[s] = f;
    Ls = fmaf(ml[2 * s + 1], f, Ls);
  }
  Ls = block_reduce<false>(Ls, red);  // its barriers also publish wts
  if (d >= D) return;
  const float* acc = part_acc + row * nsplit * D + d;
  float A = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) A = fmaf(acc[static_cast<long long>(s) * D], wts[s], A);
  out[row * D + d] = from_f32<QT>(A / (Ls > 0.f ? Ls : 1.f));
}

struct Args {
  const void *q, *kc, *ke, *vc, *ve;
  const int* lengths;
  float *part_acc, *part_ml;
  void* out;
  int B, Hkv, G, S, nbd, bs_log2, chunk, nsplit;
  float scale_log2;
  cudaStream_t stream;
};

// The split kernel of one instantiation, granted its shared memory (above
// 48 KB a block's must be asked for, once per size).
template <typename QT, typename CodeT, int D, int GT>
auto prepared(int smem) {
  auto kern = split_kernel<QT, CodeT, D, GT>;
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    granted = smem;
  }
  return kern;
}

// Launches the split and merge kernels.
struct Launch {
  const Args& a;
  template <typename QT, typename CodeT, int D, int GT>
  void run() const {
    const int smem = Geom<CodeT, D, GT>::smem_bytes(a.nbd);
    auto kern = prepared<QT, CodeT, D, GT>(smem);
    const dim3 grid(a.nsplit, a.Hkv * ((a.G + GT - 1) / GT), a.B);
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const QT*>(a.q), static_cast<const CodeT*>(a.kc),
        static_cast<const unsigned char*>(a.ke), static_cast<const CodeT*>(a.vc),
        static_cast<const unsigned char*>(a.ve), a.lengths, a.part_acc, a.part_ml, a.Hkv,
        a.G, a.S, a.nbd, a.bs_log2, a.chunk, a.nsplit, a.scale_log2);
    merge_kernel<QT><<<static_cast<unsigned>(a.B * a.Hkv * a.G), (D + 31) / 32 * 32,
                       a.nsplit * sizeof(float), a.stream>>>(
        a.part_acc, a.part_ml, static_cast<QT*>(a.out), a.nsplit, D);
  }
};

// How many split blocks of the instantiation one SM holds at once.
struct Occupancy {
  int nbd;
  int* blocks;
  cudaError_t* err;
  template <typename QT, typename CodeT, int D, int GT>
  void run() const {
    const int smem = Geom<CodeT, D, GT>::smem_bytes(nbd);
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, prepared<QT, CodeT, D, GT>(smem), kThreads, smem);
  }
};

template <typename QT, typename CodeT, int D, typename F>
void by_group(const F& f, int G) {
  if (G >= 5) f.template run<QT, CodeT, D, 8>();
  else if (G >= 3) f.template run<QT, CodeT, D, 4>();
  else if (G == 2) f.template run<QT, CodeT, D, 2>();
  else f.template run<QT, CodeT, D, 1>();
}

template <typename QT, typename CodeT, typename F>
bool by_width(const F& f, int G, int D) {
  switch (D) {
    case 64: by_group<QT, CodeT, 64>(f, G); return true;
    case 112: by_group<QT, CodeT, 112>(f, G); return true;
    case 128: by_group<QT, CodeT, 128>(f, G); return true;
    default: return false;
  }
}

template <typename QT, typename F>
bool by_codes(const F& f, int G, int D, int l) {
  switch (l) {
    case 8: return by_width<QT, unsigned char>(f, G, D);
    case 16: return by_width<QT, unsigned short>(f, G, D);
    default: return false;
  }
}

template <typename F>
bool dispatch(const F& f, int G, int D, int l, int q_kind) {
  switch (q_kind) {
    case kF32: return by_codes<float>(f, G, D, l);
    case kBF16: return by_codes<__nv_bfloat16>(f, G, D, l);
    default: return false;
  }
}

}  // namespace attn
}  // namespace frsz2

extern "C" {

// q_kind as the codec numbers value kinds (0 f32, 3 bf16); chunk a multiple
// of the tile (64 positions); code d's exponent is exps[d >> bs_log2] of its
// row: nbd << bs_log2 == D, or with one block a row (nbd = 1) any bs_log2
// with D <= 1 << bs_log2, which maps every d to 0.  Returns
// cudaGetLastError() after both launches, or cudaErrorInvalidValue for a
// shape or type it has no kernel for.
int decode_attn(const void* q, const void* kcodes, const void* kexps, const void* vcodes,
                const void* vexps, const void* lengths, void* part_acc, void* part_ml,
                void* out, int B, int Hkv, int G, int S, int D, int nbd, int bs_log2,
                int l, int q_kind, int chunk, int nsplit, float sm_scale,
                void* stream) {
  using namespace frsz2;
  if (B <= 0 || Hkv <= 0 || G <= 0 || S <= 0 || nbd <= 0 || chunk <= 0 ||
      chunk % attn::kTile != 0 || nsplit <= 0 || nsplit > 8192 ||
      (nbd == 1 ? D > 1 << bs_log2 : nbd << bs_log2 != D) ||
      static_cast<long long>(chunk) * nsplit < S ||
      static_cast<long long>(Hkv) * ((G + 7) / 8) > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const attn::Args a{q, kcodes, kexps, vcodes, vexps, static_cast<const int*>(lengths),
                     static_cast<float*>(part_acc), static_cast<float*>(part_ml), out, B, Hkv,
                     G, S, nbd, bs_log2, chunk, nsplit, sm_scale * attn::kLog2e,
                     static_cast<cudaStream_t>(stream)};
  if (!attn::dispatch(attn::Launch{a}, G, D, l, q_kind)) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// Split blocks of the kernel for (G, D, l, q_kind, nbd) that one SM holds at
// once, into *blocks: what the split rule fills one wave with.
int decode_attn_occupancy(int G, int D, int nbd, int l, int q_kind, int* blocks) {
  using namespace frsz2;
  *blocks = 0;
  cudaError_t err = cudaSuccess;
  if (G <= 0 || nbd <= 0 ||
      !attn::dispatch(attn::Occupancy{nbd, blocks, &err}, G, D, l, q_kind))
    return cudaErrorInvalidValue;
  return err;
}

}  // extern "C"
