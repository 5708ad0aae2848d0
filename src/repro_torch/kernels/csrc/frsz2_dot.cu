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
//  * matvec: a block owns 1024 columns of x, four consecutive ones a
//    thread, read once into registers, and walks every live row: one word
//    of four codes a row (a 16-byte load that bypasses L1 at l = 32), eight
//    rows' words in flight in a register ring, decoded by the exact scaled
//    decode in one FMA a code (frsz2_common.cuh::decode_fma: one range
//    guard a word, the bit decode out of line), each row's products folded
//    by a fixed warp butterfly and the block's eight warps summed in order,
//    one partial a (row, chunk); the chunks of a row are summed in a fixed
//    order by a finish kernel.  x is read once a call (the first design, a
//    block per (chunk, row), read it once a row, from L2) and no float
//    atomics are used: the result is the same bits on every run.
//  * rmatvec: each thread owns one column and walks the r rows in order,
//    h staged through shared memory, so there is no cross-block reduction
//    at all and the order of the sum is fixed.  Loads of one row are
//    coalesced across the columns of a warp.
// Codes of every width are read as unsigned integers of that width; the
// pad columns of the last block are never decoded.
#include <algorithm>

#include "frsz2_common.cuh"

namespace frsz2 {

constexpr int kDotThreads = 256;
constexpr int kRowTile = kDotThreads;              // rmatvec: rows of h staged at once
constexpr int kMvCols = 4;                         // matvec: columns a thread owns
constexpr int kChunk = kDotThreads * kMvCols;      // matvec: columns a block owns
constexpr int kMvDepth = 8;                        // matvec: rows of words in flight
constexpr int kMvWarps = kDotThreads / 32;
constexpr int kMvRowGroup = 128;                   // matvec: rows folded per barrier

template <class L>
using ValueT = typename std::conditional<(L::W > 32), double, float>::type;

// h (rows,) = decode(V[:rows]) @ x.  A block owns kChunk columns of x, each
// thread four consecutive ones, held in registers for the whole call, and
// walks all `rows` rows: one word of four codes a row (16 bytes at l = 32),
// kMvDepth rows' words (and exponents) in a register ring.  A row's four
// products are summed in column order, the warp folds them with a fixed
// shuffle butterfly, the block sums its eight warps in order through shared
// memory, and writes one partial a (row, chunk).  The chunks of a row are
// then summed in a fixed order by matvec_finish_kernel.  VEC: rows start on
// a word (npad a multiple of four, codes aligned); else the codes are read
// one by one.
template <class L, typename CodeT, bool VEC>
__global__ void __launch_bounds__(kDotThreads)
    matvec_rows_kernel(const CodeT* __restrict__ codes, const int* __restrict__ exps,
                       const ValueT<L>* __restrict__ x, ValueT<L>* __restrict__ partial,
                       int rows, long long n, long long npad, long long nb, int bs_log2) {
  using T = ValueT<L>;
  using W = Word4<CodeT>;
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));
  constexpr int C = kMvCols;
  constexpr int D = kMvDepth;
  constexpr int kSafeExp = LB;    // an in-range exponent for dead rows and columns
  static_assert(kMvRowGroup % D == 0, "a row group holds whole ring turns");
  __shared__ T wsum[kMvRowGroup][kMvWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nchunks = static_cast<int>(gridDim.x);
  const long long col = (static_cast<long long>(blockIdx.x) * kDotThreads + tid) * C;
  const int nlive = static_cast<int>(max(0LL, min(static_cast<long long>(C), n - col)));
  const bool live = nlive > 0;
  // the four columns share a codec block, and none is past n (a dead
  // thread's zero words count as whole): the scaled decode of a whole word
  const bool one_exp = VEC && bs_log2 >= 2;
  const bool whole = one_exp && (nlive == C || !live);
  const long long c0 = live ? col : 0;
  const CodeT* cbase = codes + c0;
  const int* ebase = exps + (c0 >> bs_log2);

  T xv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) xv[c] = c < nlive ? x[col + c] : T(0);

  // row r's word and exponent; zeros under an in-range exponent past the
  // rows (and, read one by one, past n)
  auto fetch = [&](int r, W& w, int& e) {
    const bool ok = live && r < rows;
    const CodeT* p = cbase + r * npad;
    if constexpr (VEC) {
      w = ok ? ld_stream(reinterpret_cast<const W*>(p)) : W{};
    } else {
      union {
        W w;
        CodeT k[C];
      } u;
#pragma unroll
      for (int c = 0; c < C; ++c) u.k[c] = ok && c < nlive ? __ldg(p + c) : CodeT(0);
      w = u.w;
    }
    e = ok && one_exp ? __ldg(ebase + r * nb) : kSafeExp;
  };

  W buf[D];
  int eb[D];
#pragma unroll
  for (int k = 0; k < D; ++k) fetch(k, buf[k], eb[k]);

  // row r = r0 + k: decode its word from ring slot k, refill the slot with
  // row r + D, fold the row's products into wsum
  auto row = [&](int k, int r, int g0) {
    T v[C];
    if (whole && fma_in_range<L, LB>(eb[k])) {
      const FmaScale<L> sc = fma_scale<L, LB>(eb[k]);
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = decode_fma<L, LB>(code_of<CodeT>(buf[k], c), sc);
    } else {
      const Quad<L> g = decode_quad<L, CodeT>(buf[k], eb[k], one_exp, ebase + r * nb,
                                              bs_log2, live ? nlive : 0);
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = g.v[c];
    }
    fetch(r + D, buf[k], eb[k]);
    T s = v[0] * xv[0];
#pragma unroll
    for (int c = 1; c < C; ++c) s = fma(v[c], xv[c], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) wsum[r - g0][warp] = s;
  };

  for (int g0 = 0; g0 < rows; g0 += kMvRowGroup) {
    const int g1 = min(rows, g0 + kMvRowGroup);
    // turns of the ring (the slot of a row is a compile-time index)
    for (int r0 = g0; r0 < g1; r0 += D) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (r0 + k >= g1) break;        // uniform across the block
        row(k, r0 + k, g0);
      }
    }
    __syncthreads();
    if (tid < g1 - g0) {
      T t = wsum[tid][0];
#pragma unroll
      for (int w = 1; w < kMvWarps; ++w) t += wsum[tid][w];
      partial[static_cast<long long>(g0 + tid) * nchunks + blockIdx.x] = t;
    }
    __syncthreads();                    // wsum is free for the next group
  }
}

// y[row] = sum of partial[row, c] over the chunks c, in a fixed order, a
// warp per row: lane i sums chunks i, i + 32, ... in turn, then a fixed
// shuffle tree.
template <typename T>
__global__ void __launch_bounds__(kDotThreads)
    matvec_finish_kernel(const T* __restrict__ partial, T* __restrict__ y, int rows,
                         int nchunks) {
  const int r = blockIdx.x * kMvWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;                // the whole warp
  const T* src = partial + static_cast<long long>(r) * nchunks;
  T acc = T(0);
  for (int c = lane; c < nchunks; c += 32) acc += src[c];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[r] = acc;
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
                   void* y, long long rows, long long n, long long npad, int bs_log2,
                   bool vec, cudaStream_t s) {
  using T = ValueT<L>;
  const long long nb = npad >> bs_log2;
  const int nchunks = static_cast<int>((n + kChunk - 1) / kChunk);
  const int r = static_cast<int>(rows);
  auto k = vec ? &matvec_rows_kernel<L, CodeT, true> : &matvec_rows_kernel<L, CodeT, false>;
  k<<<nchunks, kDotThreads, 0, s>>>(static_cast<const CodeT*>(codes), exps,
                                    static_cast<const T*>(x), static_cast<T*>(partial),
                                    r, n, npad, nb, bs_log2);
  matvec_finish_kernel<T><<<(r + kMvWarps - 1) / kMvWarps, kDotThreads, 0, s>>>(
      static_cast<const T*>(partial), static_cast<T*>(y), r, nchunks);
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
  // rows start on a word of four codes: vector loads
  const bool vec = npad % kMvCols == 0 &&
                   reinterpret_cast<unsigned long long>(codes) % (kMvCols * (l / 8)) == 0;
  switch (l) {
    case 8: launch_matvec<L, unsigned char>(codes, exps, x, partial, y, rows, n, npad, bs_log2, vec, s); return true;
    case 16: launch_matvec<L, unsigned short>(codes, exps, x, partial, y, rows, n, npad, bs_log2, vec, s); return true;
    case 32: launch_matvec<L, unsigned int>(codes, exps, x, partial, y, rows, n, npad, bs_log2, vec, s); return true;
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
  if (rows <= 0 || rows > (1LL << 31) - kMvDepth - 1 || n <= 0 || npad < n ||
      (n + kChunk - 1) / kChunk > (1LL << 31) - 1 || bs_log2 < 0 || bs_log2 > 7)
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
