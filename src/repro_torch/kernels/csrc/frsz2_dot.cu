// Fused FRSZ2 decode + contraction over a compressed row basis, for Hopper
// (sm_90a): the two basis reads of every CB-GMRES Arnoldi step.
//
// Replaces the TPU kernels `repro/kernels/frsz2_dot.py::matvec_2d`
// (pallas_call at :77; the dots h = V w) and `::rmatvec_2d` (pallas_call at
// :114; the combine w -= V^T h and the solution update).  Unlike those, the
// products here accumulate in the value type of the spec (f64 for the
// solver's formats), as `kernels/ref.py` defines them.
//
// What bounds them on this card: bytes.  Each call streams r rows of codes
// (4 B per value for l = 32) plus one exponent per block, and reads or writes
// one dense vector; it does 2 flops per decoded value, far below the card's
// f64 rate for those bytes.  The dense vector (10 MB in f64 at n = 1.26 M)
// stays in the 50 MB L2 while the rows stream past it.
//
// What the design does about it:
//  * matvec: a grid of (n-chunk, row) blocks of 256 threads.  Consecutive
//    threads read consecutive codes (coalesced), decode in registers and
//    multiply by x; each block folds its chunk with a fixed shuffle tree into
//    one partial, written to a scratch buffer.  A second small pass sums each
//    row's partials in a fixed order.  No float atomics: the result is the
//    same bits on every run.
//  * rmatvec: each thread owns one column and walks the r rows in order,
//    h staged through shared memory, so there is no cross-block reduction
//    at all and the order of the sum is fixed.  Loads of one row are
//    coalesced across the columns of a warp.
// Codes of every width are read as unsigned integers of that width; the
// pad columns of the last block are never read.
#include <algorithm>

#include "frsz2_common.cuh"

namespace frsz2 {

constexpr int kDotThreads = 256;
constexpr int kItems = 8;                          // values per thread per chunk
constexpr int kChunk = kDotThreads * kItems;       // columns per matvec block
constexpr int kRowTile = kDotThreads;              // rows of h staged at once

template <class L>
using ValueT = typename std::conditional<(L::W > 32), double, float>::type;

template <class L, typename CodeT>
__global__ void __launch_bounds__(kDotThreads)
    matvec_partial_kernel(const CodeT* __restrict__ codes,
                          const int* __restrict__ exps,
                          const ValueT<L>* __restrict__ x,
                          ValueT<L>* __restrict__ partial, long long n,
                          long long npad, long long nb, int bs_log2, int l,
                          long long nchunks) {
  using U = typename L::U;
  using T = ValueT<L>;
  const long long row = blockIdx.y;
  const long long chunk = blockIdx.x;
  const CodeT* crow = codes + row * npad;
  const int* erow = exps + row * nb;
  const long long base = chunk * kChunk + threadIdx.x;
  T acc = T(0);
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long col = base + static_cast<long long>(it) * kDotThreads;
    if (col < n) {
      const U u = decode_bits<L>(static_cast<U>(crow[col]), erow[col >> bs_log2], l);
      acc += as_value(u) * x[col];
    }
  }
  const T s = block_sum_256(acc);
  if (threadIdx.x == 0) partial[row * nchunks + chunk] = s;
}

template <typename T>
__global__ void __launch_bounds__(kDotThreads)
    matvec_finish_kernel(const T* __restrict__ partial, T* __restrict__ y,
                         long long nchunks) {
  const long long row = blockIdx.x;
  T acc = T(0);
  for (long long c = threadIdx.x; c < nchunks; c += kDotThreads)
    acc += partial[row * nchunks + c];
  const T s = block_sum_256(acc);
  if (threadIdx.x == 0) y[row] = s;
}

template <class L, typename CodeT>
__global__ void __launch_bounds__(kDotThreads)
    rmatvec_kernel(const CodeT* __restrict__ codes, const int* __restrict__ exps,
                   const ValueT<L>* __restrict__ h, ValueT<L>* __restrict__ y,
                   long long rows, long long n, long long npad, long long nb,
                   int bs_log2, int l) {
  using U = typename L::U;
  using T = ValueT<L>;
  __shared__ T hs[kRowTile];
  const long long col = static_cast<long long>(blockIdx.x) * kDotThreads + threadIdx.x;
  const bool live = col < n;
  const long long eoff = col >> bs_log2;
  T acc = T(0);
  for (long long r0 = 0; r0 < rows; r0 += kRowTile) {
    const long long left = rows - r0;
    const int cnt = left < kRowTile ? static_cast<int>(left) : kRowTile;
    __syncthreads();
    if (threadIdx.x < cnt) hs[threadIdx.x] = h[r0 + threadIdx.x];
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        const long long r = r0 + i;
        const U u = decode_bits<L>(static_cast<U>(codes[r * npad + col]),
                                   exps[r * nb + eoff], l);
        acc += hs[i] * as_value(u);
      }
    }
  }
  if (live) y[col] = acc;
}

template <class L, typename CodeT>
void launch_matvec(const void* codes, const int* exps, const void* x, void* partial,
                   void* y, long long rows, long long n, long long npad,
                   int bs_log2, int l, cudaStream_t s) {
  using T = ValueT<L>;
  const long long nb = npad >> bs_log2;
  const long long nchunks = (n + kChunk - 1) / kChunk;
  for (long long r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const unsigned gy = static_cast<unsigned>(std::min(rows - r0, kMaxGridY));
    matvec_partial_kernel<L, CodeT><<<dim3(static_cast<unsigned>(nchunks), gy),
                                      kDotThreads, 0, s>>>(
        static_cast<const CodeT*>(codes) + r0 * npad, exps + r0 * nb,
        static_cast<const T*>(x), static_cast<T*>(partial) + r0 * nchunks, n, npad,
        nb, bs_log2, l, nchunks);
  }
  matvec_finish_kernel<T><<<static_cast<unsigned>(rows), kDotThreads, 0, s>>>(
      static_cast<const T*>(partial), static_cast<T*>(y), nchunks);
}

template <class L, typename CodeT>
void launch_rmatvec(const void* codes, const int* exps, const void* h, void* y,
                    long long rows, long long n, long long npad, int bs_log2,
                    int l, cudaStream_t s) {
  using T = ValueT<L>;
  const long long nb = npad >> bs_log2;
  const unsigned gx = static_cast<unsigned>((n + kDotThreads - 1) / kDotThreads);
  rmatvec_kernel<L, CodeT><<<gx, kDotThreads, 0, s>>>(
      static_cast<const CodeT*>(codes), exps, static_cast<const T*>(h),
      static_cast<T*>(y), rows, n, npad, nb, bs_log2, l);
}

template <class L>
bool dispatch_matvec(const void* codes, const int* exps, const void* x, void* partial,
                     void* y, long long rows, long long n, long long npad,
                     int bs_log2, int l, cudaStream_t s) {
  switch (l) {
    case 8: launch_matvec<L, unsigned char>(codes, exps, x, partial, y, rows, n, npad, bs_log2, l, s); return true;
    case 16: launch_matvec<L, unsigned short>(codes, exps, x, partial, y, rows, n, npad, bs_log2, l, s); return true;
    case 32: launch_matvec<L, unsigned int>(codes, exps, x, partial, y, rows, n, npad, bs_log2, l, s); return true;
    default: return false;
  }
}

template <class L>
bool dispatch_rmatvec(const void* codes, const int* exps, const void* h, void* y,
                      long long rows, long long n, long long npad, int bs_log2,
                      int l, cudaStream_t s) {
  switch (l) {
    case 8: launch_rmatvec<L, unsigned char>(codes, exps, h, y, rows, n, npad, bs_log2, l, s); return true;
    case 16: launch_rmatvec<L, unsigned short>(codes, exps, h, y, rows, n, npad, bs_log2, l, s); return true;
    case 32: launch_rmatvec<L, unsigned int>(codes, exps, h, y, rows, n, npad, bs_log2, l, s); return true;
    default: return false;
  }
}

}  // namespace frsz2

extern "C" {

// Columns each matvec block covers: the caller sizes the (rows, nchunks)
// scratch buffer of partial sums from it.
int frsz2_matvec_chunk() { return frsz2::kChunk; }

// y (rows,) = decode(V) @ x.  codes (rows, npad), exps (rows, npad >> bs_log2),
// x (n,), partial (rows, ceil(n / chunk)).  kind: 0 = f32, 1 = f64.
int frsz2_matvec(const void* codes, const void* exps, const void* x, void* partial,
                 void* y, long long rows, long long n, long long npad, int bs_log2,
                 int kind, int l, void* stream) {
  using namespace frsz2;
  if (rows <= 0 || n <= 0 || npad < n || bs_log2 < 0 || bs_log2 > 7)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(exps);
  bool ok = false;
  switch (kind) {
    case kF32: ok = dispatch_matvec<F32>(codes, e, x, partial, y, rows, n, npad, bs_log2, l, s); break;
    case kF64: ok = dispatch_matvec<F64>(codes, e, x, partial, y, rows, n, npad, bs_log2, l, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// y (n,) = h (rows,) @ decode(V).  Same layouts as frsz2_matvec.
int frsz2_rmatvec(const void* codes, const void* exps, const void* h, void* y,
                  long long rows, long long n, long long npad, int bs_log2, int kind,
                  int l, void* stream) {
  using namespace frsz2;
  if (rows <= 0 || n <= 0 || npad < n || bs_log2 < 0 || bs_log2 > 7)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(exps);
  bool ok = false;
  switch (kind) {
    case kF32: ok = dispatch_rmatvec<F32>(codes, e, h, y, rows, n, npad, bs_log2, l, s); break;
    case kF64: ok = dispatch_rmatvec<F64>(codes, e, h, y, rows, n, npad, bs_log2, l, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
