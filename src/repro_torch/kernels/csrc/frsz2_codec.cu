// FRSZ2 compress and decompress for Hopper (sm_90a).
//
// Replaces the TPU kernels `repro/kernels/frsz2_kernel.py::compress_2d`
// (pallas_call at :113) and `::decompress_2d` (pallas_call at :75).
//
// What bounds them on this card: bytes.  Per value, compress reads the value
// (8 B for f64) and writes an l-bit code plus 4/bs B of exponent; decompress
// does the reverse.  The bit work (a block max, a few shifts, one clz) is
// tens of integer operations per value, far under the card's integer rate
// for the bytes moved.
//
// What the design does about it: one thread per value, so every warp reads
// and writes contiguous, coalesced runs of values and codes.  The block
// maximum exponent is a warp shuffle reduction inside a bs-wide lane segment
// (the paper's one-warp-per-block design at bs = 32, where it is a full warp
// max); bs = 64 and 128 fold the warp maxima through shared memory.  Nothing
// is staged in shared memory otherwise: each byte is touched once.  The
// ragged tail of a row reads as zero, so its codes are zero.
//
// Layouts (row-major, one row per blockIdx.y):
//   x     (rows, n)       value bits
//   codes (rows, npad)    npad = nb * bs, one code per element
//   exps  (rows, nb)      int32 block max exponents
#include <algorithm>

#include "frsz2_common.cuh"

namespace frsz2 {

constexpr int kThreads = 256;  // a multiple of every bs that divides 128

template <class L, typename CodeT, bool NEAREST>
__global__ void __launch_bounds__(kThreads)
    compress_kernel(const typename L::Bits* __restrict__ x,
                    CodeT* __restrict__ codes, int* __restrict__ exps,
                    long long n, long long npad, int bs_log2, int l) {
  using U = typename L::U;
  __shared__ int warp_max[kThreads / 32];
  const long long row = blockIdx.y;
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = col < npad;  // npad is a multiple of bs: whole groups
  const U u = (valid && col < n) ? static_cast<U>(x[row * n + col]) : U(0);

  U sign, sig;
  int e;
  split_bits<L>(u, sign, e, sig);

  // block max exponent over the bs lanes of this value's block
  const int bs = 1 << bs_log2;
  int emax = e;
  const int seg = bs < 32 ? bs : 32;
  for (int off = 1; off < seg; off <<= 1)
    emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, off));
  if (bs > 32) {  // uniform across the thread block
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) warp_max[warp] = emax;
    __syncthreads();
    const int per = bs >> 5;
    const int first = (warp / per) * per;
    emax = warp_max[first];
    for (int w = 1; w < per; ++w) emax = max(emax, warp_max[first + w]);
  }
  if (!valid) return;

  codes[row * npad + col] =
      static_cast<CodeT>(encode_bits<L, NEAREST>(sign, e, sig, emax, l));
  if ((col & (bs - 1)) == 0) exps[row * (npad >> bs_log2) + (col >> bs_log2)] = emax;
}

template <class L, typename CodeT>
__global__ void __launch_bounds__(kThreads)
    decompress_kernel(const CodeT* __restrict__ codes,
                      const int* __restrict__ exps,
                      typename L::Bits* __restrict__ out, long long n,
                      long long npad, int bs_log2, int l) {
  using U = typename L::U;
  const long long row = blockIdx.y;
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= n) return;
  const U c = static_cast<U>(codes[row * npad + col]);
  const int emax = exps[row * (npad >> bs_log2) + (col >> bs_log2)];
  out[row * n + col] = static_cast<typename L::Bits>(decode_bits<L>(c, emax, l));
}

template <class L, typename CodeT, bool NEAREST>
void launch_compress(const void* x, void* codes, int* exps, long long rows,
                     long long n, long long npad, int bs_log2, int l,
                     cudaStream_t stream) {
  using Bits = typename L::Bits;
  const unsigned gx = static_cast<unsigned>((npad + kThreads - 1) / kThreads);
  const long long nb = npad >> bs_log2;
  for (long long r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const unsigned gy = static_cast<unsigned>(std::min(rows - r0, kMaxGridY));
    compress_kernel<L, CodeT, NEAREST><<<dim3(gx, gy), kThreads, 0, stream>>>(
        static_cast<const Bits*>(x) + r0 * n, static_cast<CodeT*>(codes) + r0 * npad,
        exps + r0 * nb, n, npad, bs_log2, l);
  }
}

template <class L, typename CodeT>
void launch_decompress(const void* codes, const int* exps, void* out,
                       long long rows, long long n, long long npad, int bs_log2,
                       int l, cudaStream_t stream) {
  using Bits = typename L::Bits;
  const unsigned gx = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const long long nb = npad >> bs_log2;
  for (long long r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const unsigned gy = static_cast<unsigned>(std::min(rows - r0, kMaxGridY));
    decompress_kernel<L, CodeT><<<dim3(gx, gy), kThreads, 0, stream>>>(
        static_cast<const CodeT*>(codes) + r0 * npad, exps + r0 * nb,
        static_cast<Bits*>(out) + r0 * n, n, npad, bs_log2, l);
  }
}

template <class L>
bool dispatch_compress(const void* x, void* codes, int* exps, long long rows,
                       long long n, long long npad, int bs_log2, int l,
                       int nearest, cudaStream_t s) {
  switch (l * 2 + (nearest ? 1 : 0)) {
    case 16: launch_compress<L, unsigned char, false>(x, codes, exps, rows, n, npad, bs_log2, l, s); return true;
    case 17: launch_compress<L, unsigned char, true>(x, codes, exps, rows, n, npad, bs_log2, l, s); return true;
    case 32: launch_compress<L, unsigned short, false>(x, codes, exps, rows, n, npad, bs_log2, l, s); return true;
    case 33: launch_compress<L, unsigned short, true>(x, codes, exps, rows, n, npad, bs_log2, l, s); return true;
    case 64:
      if (L::W < 32) return false;
      launch_compress<L, unsigned int, false>(x, codes, exps, rows, n, npad, bs_log2, l, s); return true;
    case 65:
      if (L::W < 32) return false;
      launch_compress<L, unsigned int, true>(x, codes, exps, rows, n, npad, bs_log2, l, s); return true;
    default: return false;
  }
}

template <class L>
bool dispatch_decompress(const void* codes, const int* exps, void* out,
                         long long rows, long long n, long long npad,
                         int bs_log2, int l, cudaStream_t s) {
  switch (l) {
    case 8: launch_decompress<L, unsigned char>(codes, exps, out, rows, n, npad, bs_log2, l, s); return true;
    case 16: launch_decompress<L, unsigned short>(codes, exps, out, rows, n, npad, bs_log2, l, s); return true;
    case 32:
      if (L::W < 32) return false;
      launch_decompress<L, unsigned int>(codes, exps, out, rows, n, npad, bs_log2, l, s); return true;
    default: return false;
  }
}

}  // namespace frsz2

extern "C" {

// Each entry point returns cudaGetLastError() right after its launches, or
// cudaErrorInvalidValue for a (value kind, l) pair it has no kernel for.

int frsz2_compress(const void* x, void* codes, void* exps, long long rows,
                   long long n, long long npad, int bs_log2, int kind, int l,
                   int nearest, void* stream) {
  using namespace frsz2;
  if (rows <= 0 || npad <= 0 || bs_log2 < 0 || bs_log2 > 7) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* e = static_cast<int*>(exps);
  bool ok = false;
  switch (kind) {
    case kF32: ok = dispatch_compress<F32>(x, codes, e, rows, n, npad, bs_log2, l, nearest, s); break;
    case kF64: ok = dispatch_compress<F64>(x, codes, e, rows, n, npad, bs_log2, l, nearest, s); break;
    case kF16: ok = dispatch_compress<F16>(x, codes, e, rows, n, npad, bs_log2, l, nearest, s); break;
    case kBF16: ok = dispatch_compress<BF16>(x, codes, e, rows, n, npad, bs_log2, l, nearest, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int frsz2_decompress(const void* codes, const void* exps, void* out,
                     long long rows, long long n, long long npad, int bs_log2,
                     int kind, int l, void* stream) {
  using namespace frsz2;
  if (rows <= 0 || n <= 0 || bs_log2 < 0 || bs_log2 > 7) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(exps);
  bool ok = false;
  switch (kind) {
    case kF32: ok = dispatch_decompress<F32>(codes, e, out, rows, n, npad, bs_log2, l, s); break;
    case kF64: ok = dispatch_decompress<F64>(codes, e, out, rows, n, npad, bs_log2, l, s); break;
    case kF16: ok = dispatch_decompress<F16>(codes, e, out, rows, n, npad, bs_log2, l, s); break;
    case kBF16: ok = dispatch_decompress<BF16>(codes, e, out, rows, n, npad, bs_log2, l, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
