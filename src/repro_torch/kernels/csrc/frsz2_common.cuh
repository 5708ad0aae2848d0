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

}  // namespace frsz2
