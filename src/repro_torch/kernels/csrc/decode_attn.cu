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
// f32 rate.  What costs beyond the bytes is issue: the decode (a clz and a
// few shifts per code), a warp reduction per query head and position, and
// two exponentials per query head and position.
//
// What the design does about it (a simple first version):
// - flash-decoding: one block of four warps per (S-split, kv head, group tile
//   of <= 8 query heads, sequence), so B * Hkv * splits blocks fill the 132
//   SMs even at B * Hkv = 32; a block whose split lies wholly past
//   lengths[b] writes an empty partial and exits;
// - each warp walks its split's positions four apart; a position's D codes
//   are one coalesced load (D / 32 codes a lane), issued one position ahead,
//   decoded once in registers and used for all the tile's query heads (the
//   GQA reuse the Pallas kernel gets from its (G, D) q tile);
// - each warp keeps its own online softmax (m, l, acc) per query head; the
//   four warps merge theirs in shared memory and write one partial per split;
// - a second small kernel merges the splits into the output.
// Softmax runs in base 2 (logits pre-scaled by log2 e, exp2f), which is the
// same function.  No shared-memory ring, cp.async or TMA: later work.
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
constexpr float kLog2e = 1.4426950408889634f;

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

template <int BYTES>
struct Vec;
template <>
struct Vec<2> { using T = unsigned short; };
template <>
struct Vec<4> { using T = unsigned int; };
template <>
struct Vec<8> { using T = uint2; };

// A lane's share of one position: its VPL consecutive codes (one vector
// load; the wrapper checks the alignment) and their block exponents.  Loaded
// one position ahead of its use, so the loads overlap the previous position's
// arithmetic.
template <typename CodeT, int VPL>
struct RawRow {
  using V = typename Vec<VPL * sizeof(CodeT)>::T;
  V c;
  int em[VPL];

  __device__ __forceinline__ void load(const CodeT* c_row, const unsigned char* e, int d0,
                                       int bs_log2) {
    c = __ldg(reinterpret_cast<const V*>(c_row + d0));
    if ((1 << bs_log2) >= VPL) {  // the lane's values share one block
      const int v = static_cast<int>(__ldg(e + (d0 >> bs_log2)));
#pragma unroll
      for (int i = 0; i < VPL; ++i) em[i] = v;
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) em[i] = static_cast<int>(__ldg(e + ((d0 + i) >> bs_log2)));
    }
  }

  __device__ __forceinline__ void decode(float (&x)[VPL]) const {
    constexpr int L = 8 * sizeof(CodeT);
    const CodeT* p = reinterpret_cast<const CodeT*>(&c);
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      x[i] = as_value(decode_bits<F32>(static_cast<unsigned>(p[i]), em[i], L));
  }
};

template <typename QT, typename CodeT, int VPL, int GT>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const QT* __restrict__ q, const CodeT* __restrict__ kc,
                 const unsigned char* __restrict__ ke, const CodeT* __restrict__ vc,
                 const unsigned char* __restrict__ ve, const int* __restrict__ lengths,
                 float* __restrict__ part_acc, float* __restrict__ part_ml, int Hkv,
                 int G, int S, int nbd, int bs_log2, int chunk, int nsplit,
                 float scale_log2) {
  constexpr int D = VPL * 32;
  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][D];

  const int gtiles = (G + GT - 1) / GT;
  const int split = blockIdx.x;
  const int h = blockIdx.y / gtiles;
  const int g0 = (blockIdx.y % gtiles) * GT;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * VPL;
  const int len = min(max(lengths[b], 0), S);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const long long bh = static_cast<long long>(b) * Hkv + h;

  float qr[GT][VPL];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      qr[g][i] = g0 + g < G ? to_f32(q[(bh * G + g0 + g) * D + d0 + i]) : 0.f;

  float m[GT], lsum[GT], acc[GT][VPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    lsum[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[g][i] = 0.f;
  }

  RawRow<CodeT, VPL> kr, vr;
  int s = s0 + warp;
  if (s < s1) {
    const long long pos = bh * S + s;
    kr.load(kc + pos * D, ke + pos * nbd, d0, bs_log2);
    vr.load(vc + pos * D, ve + pos * nbd, d0, bs_log2);
  }
  for (; s < s1; s += kWarps) {
    float k[VPL], v[VPL];
    kr.decode(k);
    vr.decode(v);
    if (s + kWarps < s1) {  // the warp's next position, in flight meanwhile
      const long long pos = bh * S + s + kWarps;
      kr.load(kc + pos * D, ke + pos * nbd, d0, bs_log2);
      vr.load(vc + pos * D, ve + pos * nbd, d0, bs_log2);
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) dot = fmaf(qr[g][i], k[i], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float logit = dot * scale_log2;  // base-2 logit, finite
      const float m_new = fmaxf(m[g], logit);
      const float alpha = exp2f(m[g] - m_new);  // 0 while m is -inf
      const float p = exp2f(logit - m_new);
      lsum[g] = lsum[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[g][i] = fmaf(p, v[i], acc[g][i] * alpha);
      m[g] = m_new;
    }
  }

  // merge the four warps' softmax states, then write this split's partial
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = lsum[g];
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) sm_acc[warp][g][d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GT * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    if (g0 + g >= G) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = sm_m[w][g] == -INFINITY ? 0.f : exp2f(sm_m[w][g] - M);
      Ls = fmaf(sm_l[w][g], f, Ls);
      A = fmaf(sm_acc[w][g][d], f, A);
    }
    const long long o = (bh * G + g0 + g) * nsplit + split;
    part_acc[o * D + d] = A;
    if (d == 0) {
      part_ml[2 * o] = M;
      part_ml[2 * o + 1] = Ls;
    }
  }
}

// Block-wide max or sum over the D (64 or 128) threads of a merge block;
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

// One block of D threads per (b, query head): merge the splits' partials.
// The splits' weights exp2(m_s - M) are formed once, in shared memory
// (nsplit floats, dynamic), by the block's threads together; then each
// thread sums its column over the splits, the loads independent of each
// other.
template <typename QT>
__global__ void merge_kernel(const float* __restrict__ part_acc,
                             const float* __restrict__ part_ml, QT* __restrict__ out,
                             int nsplit, int D) {
  extern __shared__ float wts[];
  __shared__ float red[4];
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + 2 * row * nsplit;
  float M = -INFINITY;
  for (int s = d; s < nsplit; s += D) M = fmaxf(M, ml[2 * s]);
  M = block_reduce<true>(M, red);
  float Ls = 0.f;
  for (int s = d; s < nsplit; s += D) {
    const float ms = ml[2 * s];
    const float f = ms == -INFINITY ? 0.f : exp2f(ms - M);
    wts[s] = f;
    Ls = fmaf(ml[2 * s + 1], f, Ls);
  }
  Ls = block_reduce<false>(Ls, red);  // its barriers also publish wts
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

template <typename QT, typename CodeT, int VPL, int GT>
void launch(const Args& a) {
  const dim3 grid(a.nsplit, a.Hkv * ((a.G + GT - 1) / GT), a.B);
  split_kernel<QT, CodeT, VPL, GT><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const CodeT*>(a.kc),
      static_cast<const unsigned char*>(a.ke), static_cast<const CodeT*>(a.vc),
      static_cast<const unsigned char*>(a.ve), a.lengths, a.part_acc, a.part_ml, a.Hkv, a.G,
      a.S, a.nbd, a.bs_log2, a.chunk, a.nsplit, a.scale_log2);
  merge_kernel<QT><<<static_cast<unsigned>(a.B * a.Hkv * a.G), VPL * 32,
                      a.nsplit * sizeof(float), a.stream>>>(
      a.part_acc, a.part_ml, static_cast<QT*>(a.out), a.nsplit, VPL * 32);
}

template <typename QT, typename CodeT, int VPL>
void by_group(const Args& a) {
  if (a.G >= 5) launch<QT, CodeT, VPL, 8>(a);
  else if (a.G >= 3) launch<QT, CodeT, VPL, 4>(a);
  else if (a.G == 2) launch<QT, CodeT, VPL, 2>(a);
  else launch<QT, CodeT, VPL, 1>(a);
}

template <typename QT, typename CodeT>
bool by_width(const Args& a, int D) {
  switch (D) {
    case 64: by_group<QT, CodeT, 2>(a); return true;
    case 128: by_group<QT, CodeT, 4>(a); return true;
    default: return false;
  }
}

template <typename QT>
bool by_codes(const Args& a, int D, int l) {
  switch (l) {
    case 8: return by_width<QT, unsigned char>(a, D);
    case 16: return by_width<QT, unsigned short>(a, D);
    default: return false;
  }
}

}  // namespace attn
}  // namespace frsz2

extern "C" {

// q_kind as the codec numbers value kinds (0 f32, 3 bf16).  Returns
// cudaGetLastError() after both launches, or cudaErrorInvalidValue for a
// shape or type it has no kernel for.
int decode_attn(const void* q, const void* kcodes, const void* kexps, const void* vcodes,
                const void* vexps, const void* lengths, void* part_acc, void* part_ml,
                void* out, int B, int Hkv, int G, int S, int D, int nbd, int bs_log2,
                int l, int q_kind, int chunk, int nsplit, float sm_scale,
                void* stream) {
  using namespace frsz2;
  if (B <= 0 || Hkv <= 0 || G <= 0 || S <= 0 || nbd <= 0 || chunk <= 0 ||
      nsplit <= 0 || nsplit > 8192 || nbd << bs_log2 != D ||
      static_cast<long long>(chunk) * nsplit < S ||
      static_cast<long long>(Hkv) * ((G + 7) / 8) > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  attn::Args a{q, kcodes, kexps, vcodes, vexps, static_cast<const int*>(lengths),
               static_cast<float*>(part_acc), static_cast<float*>(part_ml), out, B, Hkv,
               G, S, nbd, bs_log2, chunk, nsplit, sm_scale * attn::kLog2e,
               static_cast<cudaStream_t>(stream)};
  bool ok = false;
  switch (q_kind) {
    case kF32: ok = attn::by_codes<float>(a, D, l); break;
    case kBF16: ok = attn::by_codes<__nv_bfloat16>(a, D, l); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
