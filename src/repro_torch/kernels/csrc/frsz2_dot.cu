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
//  * rmatvec: what held the first design back was its instruction count, not
//    bytes: a thread a column, one scalar load of a code and one of its
//    exponent a row, and the 64-bit bit decode inline, 41 instructions a
//    code on its hot path (kernels/sass.py), so halving the bytes (l = 16)
//    gained 2 % (281.5 us against an 83.7 us byte bound; H100 80GB HBM3,
//    700 W).  Now a thread owns G consecutive columns, one 16-byte word of
//    codes a row (G = 4, 8, 16 at l = 32, 16, 8) and one exponent a word,
//    decodes them by the scaled decode in one FMA a code (decode_fma, one
//    range guard a word; decode_quad out of line for other words), keeps
//    eight rows' words in a register ring read through pointers that step
//    a row at a time, and reads h from shared memory as broadcasts: 16 and
//    12 instructions a code at l = 32 and 16.  Decoding each row one row
//    ahead of its fmas (kernel 8's order) held two rows of values in
//    registers (142 a thread at l = 16, one block an SM) and measured
//    slower, as did 8-byte words at l = 16 and a cp.async ring in shared
//    memory.  Each column's sum stays one fma a row, in row order, from +0
//    (the first design's sum and the block combine's), so y keeps its bits
//    and there is still no cross-block reduction.
// Codes of every width are read as unsigned integers of that width.  The
// matvec never decodes the pad columns of the last block; the rmatvec
// decodes those of its last word and stores none of them.
#include <algorithm>

#include "frsz2_common.cuh"

namespace frsz2 {

constexpr int kDotThreads = 256;
constexpr int kMvCols = 4;                         // matvec: columns a thread owns
constexpr int kChunk = kDotThreads * kMvCols;      // matvec: columns a block owns
constexpr int kMvDepth = 8;                        // matvec: rows of words in flight
constexpr int kMvWarps = kDotThreads / 32;
constexpr int kMvRowGroup = 128;                   // matvec: rows folded per barrier
constexpr int kRmThreads = 128;                    // rmatvec: threads per block
constexpr int kRmWordBytes = 16;                   // rmatvec: bytes of codes a thread reads a row
constexpr int kRmDepth = 8;                        // rmatvec: rows of words in flight
constexpr int kRmRowTile = kRmThreads;             // rmatvec: rows of h staged at once

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

// y (n,) = h (rows,) @ decode(V[:rows]).  A thread owns G consecutive
// columns, one word of codes a row (16 bytes: G = 4, 8, 16 at l = 32, 16,
// 8), and walks the rows in order: kRmDepth rows' words and exponents in a
// register ring, read through pointers that step a row at a time, each
// row decoded (decode_fma, one range guard a word) as its slot comes up and
// the slot refilled with the row kRmDepth further on, h staged kRmRowTile
// rows at a time in shared memory and read as broadcasts.  Every column's
// sum is one fma a row, in row order, from +0: the first design's sum (a
// thread a column, acc += h[r] * v under --fmad=true) and the block
// combine's, bit for bit.  Columns past n in the last word are decoded (the
// codes lie inside the row's npad) and never stored.  VEC: rows start on a
// word (npad a multiple of G, codes aligned to 16 bytes); else codes are
// read one by one, none past n.  A word whose codes span several codec
// blocks (bs < G), or whose exponent lies outside the guard, takes
// decode_quad out of line.
template <class L, typename CodeT, int G, bool VEC>
__global__ void __launch_bounds__(kRmThreads)
    rmatvec_rows_kernel(const CodeT* __restrict__ codes, const int* __restrict__ exps,
                        const ValueT<L>* __restrict__ h, ValueT<L>* __restrict__ y,
                        int rows, long long n, long long npad, long long nb, int bs_log2,
                        bool one_exp) {
  using T = ValueT<L>;
  using W = CodeWord<CodeT, G>;
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));
  constexpr int D = kRmDepth;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));    // values a 16-byte store
  static_assert(kRmRowTile % D == 0, "an h tile holds whole ring turns");
  static_assert(kRmRowTile <= kRmThreads, "a thread stages one value of h");
  __shared__ T hs[kRmRowTile];
  const long long col = (static_cast<long long>(blockIdx.x) * kRmThreads + threadIdx.x) * G;
  const int nlive = static_cast<int>(max(0LL, min(static_cast<long long>(G), n - col)));
  const bool live = nlive > 0;
  const long long c0 = live ? col : 0;
  const int* ebase = exps + (c0 >> bs_log2);
  const CodeT* cnext = codes + c0;      // the next row to fetch, its codes
  const int* enext = ebase;             // and its exponent
  int rnext = 0;

  // the next row's word and exponent; zeros under an in-range exponent
  // past the rows (and, read one by one, past n)
  auto fetch = [&](W& w, int& e) {
    const bool ok = live && rnext < rows;
    if constexpr (VEC) {
      w = ok ? ld_stream(reinterpret_cast<const W*>(cnext)) : W{};
    } else {
      union {
        W w;
        CodeT k[G];
      } u;
#pragma unroll
      for (int c = 0; c < G; ++c) u.k[c] = ok && c < nlive ? __ldg(cnext + c) : CodeT(0);
      w = u.w;
    }
    e = ok && one_exp ? __ldg(enext) : LB;
    cnext += npad;
    enext += nb;
    ++rnext;
  };

  W buf[D];
  int eb[D];
#pragma unroll
  for (int k = 0; k < D; ++k) fetch(buf[k], eb[k]);
  T acc[G];
#pragma unroll
  for (int c = 0; c < G; ++c) acc[c] = T(0);
  for (int r0 = 0; r0 < rows; r0 += D) {
    const int t0 = r0 - r0 % kRmRowTile;
    if (r0 == t0) {                     // stage the tile of h from row r0
      __syncthreads();
      if (static_cast<int>(threadIdx.x) < min(kRmRowTile, rows - r0))
        hs[threadIdx.x] = h[r0 + threadIdx.x];
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int r = r0 + k;
      if (r >= rows) break;             // uniform across the block
      T v[G];
      if (one_exp && fma_in_range<L, LB>(eb[k])) {
        const FmaScale<L> sc = fma_scale<L, LB>(eb[k]);
#pragma unroll
        for (int c = 0; c < G; ++c) v[c] = decode_fma<L, LB>(code_of<CodeT, G>(buf[k], c), sc);
      } else {
        const Quad<L, G> g = decode_quad<L, CodeT, G>(
            buf[k], eb[k], one_exp, ebase + static_cast<long long>(r) * nb, bs_log2,
            live ? nlive : 0);
#pragma unroll
        for (int c = 0; c < G; ++c) v[c] = g.v[c];
      }
      fetch(buf[k], eb[k]);             // row r + D into the slot just read
      const T hr = hs[r - t0];
#pragma unroll
      for (int c = 0; c < G; ++c) acc[c] = fma(hr, v[c], acc[c]);
    }
  }
  if (!live) return;
  T* o = y + col;
  if (nlive == G && (reinterpret_cast<unsigned long long>(y) & 15) == 0) {
#pragma unroll
    for (int c = 0; c < G; c += kVec) {
      union {
        uint4 u;
        T t[kVec];
      } ov;
#pragma unroll
      for (int j = 0; j < kVec; ++j) ov.t[j] = acc[c + j];
      *reinterpret_cast<uint4*>(o + c) = ov.u;
    }
  } else {
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c < nlive) o[c] = acc[c];
  }
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
                    long long rows, long long n, long long npad, int bs_log2, bool vec,
                    cudaStream_t s) {
  using T = ValueT<L>;
  constexpr int G = kRmWordBytes / static_cast<int>(sizeof(CodeT));
  constexpr int kGLog2 = G == 16 ? 4 : G == 8 ? 3 : 2;
  const long long nb = npad >> bs_log2;
  const long long words = (n + G - 1) / G;
  const unsigned gx = static_cast<unsigned>((words + kRmThreads - 1) / kRmThreads);
  auto k = vec ? &rmatvec_rows_kernel<L, CodeT, G, true>
               : &rmatvec_rows_kernel<L, CodeT, G, false>;
  k<<<gx, kRmThreads, 0, s>>>(static_cast<const CodeT*>(codes), exps,
                               static_cast<const T*>(h), static_cast<T*>(y),
                               static_cast<int>(rows), n, npad, nb, bs_log2,
                               bs_log2 >= kGLog2);
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
                      int l, bool vec, cudaStream_t s) {
  switch (l) {
    case 8: launch_rmatvec<L, unsigned char>(codes, exps, h, y, rows, n, npad, bs_log2, vec, s); return true;
    case 16: launch_rmatvec<L, unsigned short>(codes, exps, h, y, rows, n, npad, bs_log2, vec, s); return true;
    case 32: launch_rmatvec<L, unsigned int>(codes, exps, h, y, rows, n, npad, bs_log2, vec, s); return true;
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

// Bytes of codes each rmatvec thread reads a row as one word: the caller
// asks for the vector route (vec = 1) only where npad is a multiple of the
// codes a word and the codes start on a word.
int frsz2_rmatvec_word_bytes() { return frsz2::kRmWordBytes; }

// y (n,) = h (rows,) @ decode(V).  Same layouts as frsz2_matvec; vec: read
// the codes as words (see frsz2_rmatvec_word_bytes), else one by one.
int frsz2_rmatvec(const void* codes, const void* exps, const void* h, void* y,
                  long long rows, long long n, long long npad, int bs_log2, int kind,
                  int l, int vec, void* stream) {
  using namespace frsz2;
  const long long g = (l == 8 || l == 16 || l == 32) ? kRmWordBytes / (l / 8) : 1;
  if (rows <= 0 || rows > (1LL << 31) - kRmDepth - 1 || n <= 0 || npad < n ||
      ((n + g - 1) / g + kRmThreads - 1) / kRmThreads > (1LL << 31) - 1 ||
      bs_log2 < 0 || bs_log2 > 7 ||
      (vec && (npad % g ||
               reinterpret_cast<unsigned long long>(codes) % kRmWordBytes)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(exps);
  bool ok = false;
  switch (kind) {
    case kF32: ok = dispatch_rmatvec<F32>(codes, e, h, y, rows, n, npad, bs_log2, l, vec, s); break;
    case kF64: ok = dispatch_rmatvec<F64>(codes, e, h, y, rows, n, npad, bs_log2, l, vec, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
