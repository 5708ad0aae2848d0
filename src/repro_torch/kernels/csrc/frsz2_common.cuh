// FRSZ2 bit codec shared by the Hopper kernels (device functions only).
//
// The arithmetic is the one `repro_torch/core/frsz2.py` defines: encode takes
// a value's IEEE fields and the block's max exponent e_max to an l-bit code
// [sign | integer bit | fraction bits]; decode recovers k = e_max - e from the
// leading zeros of the (l-1)-bit significand field and re-packs an IEEE word.
// Shift counts are clamped to [0, W-1] exactly as the reference clamps them,
// so both sides agree bit for bit even where a shift would overflow.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace frsz2 {

// IEEE layout of a value type.  `Bits` is its storage word; `U` the word the
// codec computes in (32 bits for 16- and 32-bit values, 64 bits otherwise).
template <int W_, int MANT_, int EXPB_>
struct Layout {
  static constexpr int W = W_;
  static constexpr int MANT = MANT_;
  static constexpr int EXPB = EXPB_;
  using U = typename std::conditional<(W_ > 32), unsigned long long,
                                      unsigned int>::type;
  using Bits = typename std::conditional<
      (W_ > 32), unsigned long long,
      typename std::conditional<(W_ > 16), unsigned int,
                                unsigned short>::type>::type;
};

using F32 = Layout<32, 23, 8>;
using F64 = Layout<64, 52, 11>;
using F16 = Layout<16, 10, 5>;
using BF16 = Layout<16, 7, 8>;

// value kinds as the Python wrappers number them
enum ValueKind { kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3 };

// Leading zeros of x read as a W-bit word.
template <int W>
__device__ __forceinline__ int clz_w(unsigned int x) {
  return __clz(static_cast<int>(x)) - (32 - W);
}
template <int W>
__device__ __forceinline__ int clz_w(unsigned long long x) {
  return __clzll(static_cast<long long>(x)) - (64 - W);
}

// Steps 1-2 of compression: sign, biased exponent, significand with the
// explicit leading one.  Subnormals (e == 0) encode as zero.
template <class L>
__device__ __forceinline__ void split_bits(typename L::U u, typename L::U& sign,
                                           int& e, typename L::U& sig) {
  using U = typename L::U;
  const U one = 1;
  sign = (u >> (L::MANT + L::EXPB)) & one;
  e = static_cast<int>((u >> L::MANT) & ((one << L::EXPB) - one));
  const U m = u & ((one << L::MANT) - one);
  sig = e > 0 ? (m | (one << L::MANT)) : U(0);
}

// Steps 3-5: normalise to e_max, cut (or round) to l bits, prepend the sign.
template <class L, bool NEAREST>
__device__ __forceinline__ typename L::U encode_bits(typename L::U sign, int e,
                                                     typename L::U sig,
                                                     int emax, int l) {
  using U = typename L::U;
  const U one = 1;
  const int shift = L::MANT - (l - 2) + (emax - e);
  const int rs = min(max(shift, 0), L::W - 1);
  const int ls = min(max(-shift, 0), L::W - 1);
  if (NEAREST && shift > 0 && rs > 0) sig += one << (rs - 1);
  U csig = shift >= 0 ? (sig >> rs) : (sig << ls);
  if (shift >= L::W) csig = 0;
  const U field_max = (one << (l - 1)) - one;
  csig = csig < field_max ? csig : field_max;
  return (sign << (l - 1)) | csig;
}

// Decompression: code c (zero-extended) and block exponent -> IEEE bits.
template <class L>
__device__ __forceinline__ typename L::U decode_bits(typename L::U c, int emax,
                                                     int l) {
  using U = typename L::U;
  const U one = 1;
  const U sign = (c >> (l - 1)) & one;
  const U csig = c & ((one << (l - 1)) - one);
  const bool zero = csig == 0;
  const int k = zero ? 0 : clz_w<L::W>(csig) - (L::W - (l - 1));
  int e = emax - k;
  const int nf = l - 2 - k;
  const U frac = zero ? csig : (csig ^ (one << max(nf, 0)));
  const int d = L::MANT - nf;
  U m = d >= 0 ? (frac << min(d, L::W - 1)) : (frac >> min(-d, L::W - 1));
  if (zero || e <= 0) {  // flush to (signed) zero
    e = 0;
    m = 0;
  }
  const U u = (sign << (L::MANT + L::EXPB)) | (static_cast<U>(e) << L::MANT) | m;
  return L::W == 16 ? (u & 0xFFFFu) : u;
}

__device__ __forceinline__ float as_value(unsigned int u) {
  return __uint_as_float(u);
}
__device__ __forceinline__ double as_value(unsigned long long u) {
  return __longlong_as_double(static_cast<long long>(u));
}

// The value type of a layout: what the contractions compute in.
template <class L>
using Value = typename std::conditional<(L::W > 32), double, float>::type;

// Scaled decode: the same value as as_value(decode_bits<L>(c, emax, LB)),
// bit for bit, in a few instructions instead of ~30 of 64-bit bit work.
//
// Identity.  A code c of LB bits has the sign s = c >> (LB-1) and the
// significand field csig = c & (2^(LB-1) - 1).  decode_bits finds k from
// the leading zeros of csig, keeps nf = LB-2-k fraction bits below its
// leading one and re-packs exponent emax - k, so the value it returns is
//     (-1)^s * csig * 2^(emax - bias - (LB-2))
// as long as nothing is flushed or overflows:
//   * emax >= LB-1: the smallest exponent, emax - (LB-2), is a normal one
//     (>= 1), so no nonzero code flushes to zero;
//   * emax <= 2*bias: the largest, emax with k = 0, stays finite, and the
//     scale 2^(emax - bias - (LB-2)) is itself a normal power of two.
// In that range csig converts exactly to f64 (csig < 2^31 < 2^53), and to
// f32 by truncation to 24 bits (round toward zero), which is the cut that
// decode_bits makes when nf > 23; the product with the power-of-two scale
// is exact.  A zero field gives +0 * scale, and the sign bit is set on the
// result afterwards, so -0 comes out as decode_bits gives it.
//
// Guard.  Outside the range (emax < LB-1: the flush zone; emax > 2*bias:
// Inf/NaN patterns, or exponents no compress writes) the caller takes
// decode_bits.  No Krylov vector has a block there, so the guard is one
// compare per block, and the branch it takes is uniform in practice.
template <class L, int LB>
__device__ __forceinline__ bool scaled_in_range(int emax) {
  constexpr int kBias = (1 << (L::EXPB - 1)) - 1;
  return static_cast<unsigned>(emax - (LB - 1)) <=
         static_cast<unsigned>(2 * kBias - (LB - 1));
}

// The high 32-bit word of the block's scale 2^(emax - bias - (LB-2)): its
// biased exponent emax - (LB-2) in the exponent field (valid in range).
template <class L, int LB>
__device__ __forceinline__ unsigned scale_hi(int emax) {
  return static_cast<unsigned>(emax - (LB - 2)) << (L::MANT - (L::W - 32));
}

// The sign of code c, moved to bit 31.
template <int LB>
__device__ __forceinline__ unsigned code_sign31(unsigned c) {
  return LB == 32 ? (c & 0x80000000u) : ((c << (32 - LB)) & 0x80000000u);
}

// In-range decode of code c (zero-extended) given its block's scale_hi.
template <class L, int LB>
__device__ __forceinline__ Value<L> decode_scaled_fast(unsigned c, unsigned shi) {
  const unsigned csig = c & ((1u << (LB - 1)) - 1u);
  if constexpr (L::W > 32) {
    // 2^52 + csig as an IEEE double, minus 2^52: csig exactly, in one DADD
    const double x = __dsub_rn(__hiloint2double(0x43300000, static_cast<int>(csig)),
                               4503599627370496.0);
    const double v = __dmul_rn(x, __hiloint2double(static_cast<int>(shi), 0));
    return __hiloint2double(__double2hiint(v) | static_cast<int>(code_sign31<LB>(c)),
                            __double2loint(v));
  } else {
    const float x = __uint2float_rz(csig);
    const float v = __fmul_rn(x, __uint_as_float(shi));
    return __uint_as_float(__float_as_uint(v) | code_sign31<LB>(c));
  }
}

// decode_bits as a value, out of line: the rare path of the guarded decode
// stays out of the kernels' hot loops (and their instruction caches)
template <class L>
__device__ __noinline__ Value<L> decode_bits_value(unsigned c, int emax, int l) {
  return as_value(decode_bits<L>(static_cast<typename L::U>(c), emax, l));
}

// The guarded decode: decode_scaled_fast in range, decode_bits outside.
template <class L, int LB>
__device__ __forceinline__ Value<L> decode_scaled(unsigned c, int emax) {
  if (scaled_in_range<L, LB>(emax)) return decode_scaled_fast<L, LB>(c, scale_hi<L, LB>(emax));
  return decode_bits_value<L>(c, emax, LB);
}

// Deterministic sum over a block of 256 threads: a fixed shuffle tree per
// warp, then warp 0 folds the eight warp sums in order.  The result is valid
// in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum_256(T v) {
  __shared__ T warp_sums[8];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < 8 ? warp_sums[lane] : T(0);
    for (int off = 4; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Grids put rows on blockIdx.y, which holds at most 65535.
constexpr long long kMaxGridY = 65535;

// Asynchronous 16-byte copies global -> shared (sm_80+): no register
// staging, as many in flight as a thread issues; completion in groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace frsz2
