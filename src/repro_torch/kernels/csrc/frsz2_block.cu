// Fused FRSZ2 decode + block contraction over a compressed block basis, for
// Hopper (sm_90a): the two basis reads of every block-GMRES Arnoldi step.
//
// Replaces the TPU kernels `repro/kernels/frsz2_block.py::block_dots_2d`
// (pallas_call at :64; the block dots H = V W^T) and `::block_combine_2d`
// (pallas_call at :104; the block combine W -= Y^T V and the block solution
// update).  A flat block store of `rows` block rows of p segments is viewed
// as M = rows * p segment rows of n_seg codes (`ops.block_dots`), so
//   dots:    Y (M, q)     = decode(V) @ W^T,   W (q, n_seg)
//   combine: out (q, n_seg) = Y^T @ decode(V), Y (M, q)
// with q <= 16 right-hand sides.  Products accumulate in the value type of
// the spec (f64 for the solver's formats), as the Pallas kernels do.
//
// What bounds them on this card: at the main-path block shape (frsz2_32,
// p = q = 8, n_seg = 1,259,776, 101 block rows = 808 segment rows) one call
// streams 4.07 GB of codes and 0.13 GB of exponents: 1.26 ms at 3.35 TB/s.
// The f64 FMAs (q per decoded value, 8.1 G) take 0.48 ms at 34 TFLOP/s.
// The decode is integer work, ~25-30 instructions per code (64-bit shifts
// are pairs of 32-bit ones), about 1.5 ms of INT32 issue for 1 G codes at
// 64 lanes per SM per clock: issue rate, not bytes, is the first limit of
// this simple design, and the decode is amortized over q only by doing it
// once per code.
//
// What the design does about it:
//  * each code is decoded exactly once and multiplied by all q right-hand
//    sides from registers or a shared-memory broadcast;
//  * dots: eight lanes share a segment row (four rows per warp) and walk a
//    chunk of its columns with 16-byte loads, so one load instruction reads
//    128 contiguous bytes of each of four rows (coalesced; a first design
//    with one row per thread, 32 scattered rows per load, took 5.3 ms at
//    101 rows).  W's chunk is staged transposed in shared memory (256
//    columns x q, padded so that the eight lanes of a row hit distinct
//    banks); each lane keeps q accumulators per row in registers, and the
//    eight lanes of a row fold them with a fixed shuffle butterfly once
//    per chunk.  A block covers 64 rows, so a W chunk staged once serves
//    64 rows.  Each (row, chunk) writes its q partial sums to a scratch
//    buffer and a second pass sums a row's chunks in order;
//  * combine: a thread owns one column and walks the M segment rows in
//    order, Y staged in shared memory (256 rows x q, a broadcast), with q
//    accumulators in registers; loads of one row are coalesced across the
//    columns of a warp;
//  * no float atomics and a fixed order of every sum, so the result is the
//    same bits on every run;
//  * the pad columns of each segment are stored as zero codes, which decode
//    to exact zeros: they add nothing, and W's pad columns are zero too.
#include <algorithm>

#include "frsz2_common.cuh"

namespace frsz2_block {

using namespace frsz2;

constexpr int kDotThreads = 256;   // dots: threads per block
constexpr int kLanesPerRow = 8;    // dots: lanes sharing one segment row
constexpr int kPasses = 2;         // dots: rows each lane group walks
constexpr int kRowsPerBlock = kDotThreads / kLanesPerRow * kPasses;   // 64
constexpr int kSubCols = 256;      // dots: W columns staged at once
constexpr int kColThreads = 256;   // combine: columns per block
constexpr int kRowTile = 256;      // combine: rows of Y staged at once
constexpr int kMaxQ = 16;

template <class L>
using ValueT = typename std::conditional<(L::W > 32), double, float>::type;

// the exponent of code `col` of a row whose exponents start at `erow`
__device__ __forceinline__ int exp_at(const int* __restrict__ erow, long long col,
                                      int bs_log2) {
  return __ldg(erow + (col >> bs_log2));
}

template <class L, typename CodeT, int Q>
__global__ void __launch_bounds__(kDotThreads)
    block_dots_partial(const CodeT* __restrict__ codes, const int* __restrict__ exps,
                       const ValueT<L>* __restrict__ W, ValueT<L>* __restrict__ partial,
                       long long M, long long n_seg, int q, long long chunk_cols,
                       long long nchunks, int bs_log2, int l) {
  using U = typename L::U;
  using T = ValueT<L>;
  constexpr int G = 16 / static_cast<int>(sizeof(CodeT));   // codes per 16-byte load
  constexpr int kStep = kLanesPerRow * G;                    // columns per row per step
  // W's sub-chunk, column c at c*Q + (c/G)*2: one 16-byte pad per G columns
  // puts the eight lanes of a row (G columns apart) on distinct banks
  __shared__ __align__(16) T xs[kSubCols * Q + kSubCols / G * 2];
  const int lane = threadIdx.x & 31;
  const int sl = lane & (kLanesPerRow - 1);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                         (threadIdx.x >> 3);               // + pass * 32
  const long long chunk = blockIdx.y;
  const long long c0 = chunk * chunk_cols;
  const long long c1 = min(c0 + chunk_cols, n_seg);
  const long long nb = n_seg >> bs_log2;
  T acc[kPasses][Q];
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps)
#pragma unroll
    for (int b = 0; b < Q; ++b) acc[ps][b] = T(0);
  for (long long s0 = c0; s0 < c1; s0 += kSubCols) {
    const int cnt = static_cast<int>(min(static_cast<long long>(kSubCols), c1 - s0));
    __syncthreads();
    for (int b = 0; b < Q; ++b)
      for (int c = threadIdx.x; c < cnt; c += kDotThreads)
        xs[c * Q + (c / G) * 2 + b] =
            b < q ? W[static_cast<long long>(b) * n_seg + s0 + c] : T(0);
    __syncthreads();
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const long long row = row0 + ps * (kDotThreads / kLanesPerRow);
      if (row >= M) continue;
      const CodeT* crow = codes + row * n_seg + s0;
      const int* erow = exps + row * nb;
      for (int c = sl * G; c < cnt; c += kStep) {
        // n_seg and every chunk start are multiples of 128 codes: each
        // lane's G codes are one aligned 16-byte word
        union {
          uint4 v;
          CodeT k[G];
        } grp;
        grp.v = __ldg(reinterpret_cast<const uint4*>(crow + c));
        const int e_grp = exp_at(erow, s0 + c, bs_log2);
        const T* x = xs + c * Q + (c / G) * 2;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int e = (G >> bs_log2) <= 1 ? e_grp : exp_at(erow, s0 + c + i, bs_log2);
          const T v = as_value(decode_bits<L>(static_cast<U>(grp.k[i]), e, l));
#pragma unroll
          for (int b = 0; b < Q; ++b) acc[ps][b] += v * x[i * Q + b];
        }
      }
    }
  }
  // fold the eight lanes of each row: a fixed butterfly, lane 0's sum kept
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps) {
#pragma unroll
    for (int b = 0; b < Q; ++b)
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        acc[ps][b] += __shfl_xor_sync(0xffffffffu, acc[ps][b], off);
    const long long row = row0 + ps * (kDotThreads / kLanesPerRow);
    if (sl == 0 && row < M) {
      T* out = partial + (row * nchunks + chunk) * q;
#pragma unroll
      for (int b = 0; b < Q; ++b)
        if (b < q) out[b] = acc[ps][b];
    }
  }
}

// Y[r, b] = sum of partial[r, c, b] over the chunks c, in order.
template <typename T>
__global__ void __launch_bounds__(256)
    block_dots_finish(const T* __restrict__ partial, T* __restrict__ Y, long long M,
                      long long nchunks, int q) {
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= M * q) return;
  const long long row = idx / q;
  const int b = static_cast<int>(idx - row * q);
  const T* src = partial + row * nchunks * q + b;
  T acc = T(0);
  for (long long c = 0; c < nchunks; ++c) acc += src[c * q];
  Y[idx] = acc;
}

template <class L, typename CodeT, int Q>
__global__ void __launch_bounds__(kColThreads)
    block_combine_kernel(const CodeT* __restrict__ codes, const int* __restrict__ exps,
                         const ValueT<L>* __restrict__ Y, ValueT<L>* __restrict__ out,
                         long long M, long long n_seg, int q, int bs_log2, int l) {
  using U = typename L::U;
  using T = ValueT<L>;
  __shared__ __align__(16) T ys[kRowTile][Q];
  const long long col = static_cast<long long>(blockIdx.x) * kColThreads + threadIdx.x;
  const bool live = col < n_seg;
  const long long nb = n_seg >> bs_log2;
  const long long eoff = col >> bs_log2;
  T acc[Q];
#pragma unroll
  for (int b = 0; b < Q; ++b) acc[b] = T(0);
  for (long long r0 = 0; r0 < M; r0 += kRowTile) {
    const int cnt = static_cast<int>(min(static_cast<long long>(kRowTile), M - r0));
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * Q; e += kColThreads) {
      const int r = e / Q;
      const int b = e - r * Q;
      ys[r][b] = b < q ? Y[(r0 + r) * q + b] : T(0);
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        const long long r = r0 + i;
        const T v = as_value(decode_bits<L>(static_cast<U>(__ldg(codes + r * n_seg + col)),
                                            __ldg(exps + r * nb + eoff), l));
#pragma unroll
        for (int b = 0; b < Q; ++b) acc[b] += ys[i][b] * v;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int b = 0; b < Q; ++b)
      if (b < q) out[static_cast<long long>(b) * n_seg + col] = acc[b];
  }
}

template <class L, typename CodeT, int Q>
void launch_dots(const void* codes, const int* exps, const void* W, void* partial, void* Y,
                 long long M, long long n_seg, int q, long long chunk_cols, int bs_log2,
                 int l, cudaStream_t s) {
  using T = ValueT<L>;
  const long long nchunks = (n_seg + chunk_cols - 1) / chunk_cols;
  const dim3 grid(static_cast<unsigned>((M + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned>(nchunks));
  block_dots_partial<L, CodeT, Q><<<grid, kDotThreads, 0, s>>>(
      static_cast<const CodeT*>(codes), exps, static_cast<const T*>(W),
      static_cast<T*>(partial), M, n_seg, q, chunk_cols, nchunks, bs_log2, l);
  block_dots_finish<T><<<static_cast<unsigned>((M * q + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(partial), static_cast<T*>(Y), M, nchunks, q);
}

template <class L, typename CodeT, int Q>
void launch_combine(const void* codes, const int* exps, const void* Y, void* out,
                    long long M, long long n_seg, int q, int bs_log2, int l,
                    cudaStream_t s) {
  using T = ValueT<L>;
  const unsigned gx = static_cast<unsigned>((n_seg + kColThreads - 1) / kColThreads);
  block_combine_kernel<L, CodeT, Q><<<gx, kColThreads, 0, s>>>(
      static_cast<const CodeT*>(codes), exps, static_cast<const T*>(Y), static_cast<T*>(out),
      M, n_seg, q, bs_log2, l);
}

// The accumulators live in registers, so the block width is a template
// parameter: q is rounded up to 4, 8 or 16 and the extra columns are zero.
template <class L, typename CodeT>
bool dots_q(const void* codes, const int* exps, const void* W, void* partial, void* Y,
            long long M, long long n_seg, int q, long long chunk_cols, int bs_log2, int l,
            cudaStream_t s) {
  if (q <= 4)
    launch_dots<L, CodeT, 4>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, l, s);
  else if (q <= 8)
    launch_dots<L, CodeT, 8>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, l, s);
  else
    launch_dots<L, CodeT, 16>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, l, s);
  return true;
}

template <class L, typename CodeT>
bool combine_q(const void* codes, const int* exps, const void* Y, void* out, long long M,
               long long n_seg, int q, int bs_log2, int l, cudaStream_t s) {
  if (q <= 4)
    launch_combine<L, CodeT, 4>(codes, exps, Y, out, M, n_seg, q, bs_log2, l, s);
  else if (q <= 8)
    launch_combine<L, CodeT, 8>(codes, exps, Y, out, M, n_seg, q, bs_log2, l, s);
  else
    launch_combine<L, CodeT, 16>(codes, exps, Y, out, M, n_seg, q, bs_log2, l, s);
  return true;
}

template <class L>
bool dispatch_dots(const void* codes, const int* exps, const void* W, void* partial, void* Y,
                   long long M, long long n_seg, int q, long long chunk_cols, int bs_log2,
                   int l, cudaStream_t s) {
  switch (l) {
    case 8: return dots_q<L, unsigned char>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, l, s);
    case 16: return dots_q<L, unsigned short>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, l, s);
    case 32: return dots_q<L, unsigned int>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, l, s);
    default: return false;
  }
}

template <class L>
bool dispatch_combine(const void* codes, const int* exps, const void* Y, void* out,
                      long long M, long long n_seg, int q, int bs_log2, int l,
                      cudaStream_t s) {
  switch (l) {
    case 8: return combine_q<L, unsigned char>(codes, exps, Y, out, M, n_seg, q, bs_log2, l, s);
    case 16: return combine_q<L, unsigned short>(codes, exps, Y, out, M, n_seg, q, bs_log2, l, s);
    case 32: return combine_q<L, unsigned int>(codes, exps, Y, out, M, n_seg, q, bs_log2, l, s);
    default: return false;
  }
}

}  // namespace frsz2_block

extern "C" {

// Y (M, q) = decode(V) @ W^T.  codes (M, n_seg) of width l, exps
// (M, n_seg >> bs_log2), W (q, n_seg), partial (M, ceil(n_seg / chunk_cols), q)
// scratch; n_seg a multiple of 128, chunk_cols a multiple of 256.
// kind: 0 = f32, 1 = f64 values (and W, Y).
int frsz2_block_dots(const void* codes, const void* exps, const void* W, void* partial,
                     void* Y, long long M, long long n_seg, int q, long long chunk_cols,
                     int bs_log2, int kind, int l, void* stream) {
  using namespace frsz2_block;
  if (M <= 0 || n_seg <= 0 || n_seg % 128 || q < 1 || q > kMaxQ || chunk_cols <= 0 ||
      chunk_cols % kSubCols || bs_log2 < 0 || bs_log2 > 7 ||
      (n_seg + chunk_cols - 1) / chunk_cols > kMaxGridY || M > (1LL << 31) * kRowsPerBlock)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(exps);
  bool ok = false;
  switch (kind) {
    case kF32: ok = dispatch_dots<F32>(codes, e, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, l, s); break;
    case kF64: ok = dispatch_dots<F64>(codes, e, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, l, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// out (q, n_seg) = Y^T @ decode(V).  codes/exps as frsz2_block_dots, Y (M, q).
int frsz2_block_combine(const void* codes, const void* exps, const void* Y, void* out,
                        long long M, long long n_seg, int q, int bs_log2, int kind, int l,
                        void* stream) {
  using namespace frsz2_block;
  if (M <= 0 || n_seg <= 0 || n_seg % 128 || q < 1 || q > kMaxQ || bs_log2 < 0 ||
      bs_log2 > 7 || (n_seg + kColThreads - 1) / kColThreads > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(exps);
  bool ok = false;
  switch (kind) {
    case kF32: ok = dispatch_combine<F32>(codes, e, Y, out, M, n_seg, q, bs_log2, l, s); break;
    case kF64: ok = dispatch_combine<F64>(codes, e, Y, out, M, n_seg, q, bs_log2, l, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
