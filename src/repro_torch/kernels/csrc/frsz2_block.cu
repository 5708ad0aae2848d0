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
// streams 4.07 GB of codes and 0.13 GB of exponents: 1.28 ms at 3.35 TB/s.
// The f64 FMAs (q per decoded value, 8.1 G) take 0.48 ms at 34 TFLOP/s.
// The bit decode (decode_bits) is ~25-30 integer instructions a code
// (64-bit shifts are pairs of 32-bit ones): with it the first dots kernel
// was issue-bound at 3.68 ms, slower than torch.mm reading a
// decoded basis of twice the bytes (2.64 ms; H100 80GB HBM3, 700 W).  The
// combine still decodes that way.
//
// What the dots' design does about it (1.96 ms at 101 rows, 1.14 ms at 51;
// SASS and ablations in PERF.md):
//  * each code is decoded once, by the exact scaled decode (frsz2_common.cuh:
//    a mask, one DADD, one multiply by the block's power of two, the sign;
//    the bit decode only out of line, for blocks outside its range), and
//    multiplied by all q right-hand sides from registers;
//  * eight lanes share a segment row (four rows per warp) and walk a chunk
//    of its columns with 16-byte loads that bypass L1, so one load
//    instruction reads 128 contiguous bytes of each of four rows; each lane
//    takes two rows (64 rows a block), so every W value it loads from
//    shared memory serves two codes;
//  * two register buffers of code words in turn: a step's words are decoded
//    into values first, then the buffer is refilled with the words two steps
//    ahead, so two loads a row are in flight while a step computes;
//  * W's chunk arrives in 256-column stages by cp.async into a ring of three
//    (one barrier a stage, no thread copies through registers), laid out as
//    in device memory with the 16-byte chunks of a row swizzled so that the
//    eight lanes of a row hit eight bank groups;
//  * each lane keeps q accumulators per row in registers, and the eight
//    lanes of a row fold them with a fixed shuffle butterfly once per chunk;
//    each (row, chunk) writes its q partial sums to a scratch buffer and a
//    second pass sums a row's chunks, a warp per (row, right-hand side) in
//    a fixed order;
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
constexpr int kRowsPerLane = 2;    // dots: rows each lane walks together
constexpr int kRowSlots = kDotThreads / kLanesPerRow;                 // 32
constexpr int kRowsPerBlock = kRowSlots * kRowsPerLane;               // 64
constexpr int kSubCols = 256;      // dots: chunk_cols is a multiple of it
constexpr int kStages = 3;         // dots: W ring depth in shared memory
constexpr int kColThreads = 256;   // combine: columns per block
constexpr int kRowTile = 256;      // combine: rows of Y staged at once
constexpr int kMaxQ = 16;

template <class L>
using ValueT = Value<L>;

// dots: W columns one ring stage holds (16 KB of f64 values at most)
template <int Q>
__host__ __device__ constexpr int stage_cols() {
  return Q > 8 ? 128 : 256;
}

// the exponent of code `col` of a row whose exponents start at `erow`
__device__ __forceinline__ int exp_at(const int* __restrict__ erow, long long col,
                                      int bs_log2) {
  return __ldg(erow + (col >> bs_log2));
}

// A 16-byte load that does not allocate in L1: the codes are read once.
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// The G codes of one 16-byte word, decoded one by one by the guarded
// decode, each with its own block's exponent where a word spans blocks:
// the rare path of the dots, out of line.
template <class L, typename CodeT>
struct Group {
  ValueT<L> v[16 / sizeof(CodeT)];
};
template <class L, typename CodeT>
__device__ __noinline__ Group<L, CodeT> decode_group(uint4 word, int e, bool one_exp,
                                                    const int* __restrict__ erow,
                                                    long long col, int bs_log2) {
  constexpr int G = 16 / static_cast<int>(sizeof(CodeT));
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));
  union {
    uint4 v;
    CodeT k[G];
  } grp;
  grp.v = word;
  Group<L, CodeT> out;
#pragma unroll
  for (int i = 0; i < G; ++i)
    out.v[i] = decode_scaled<L, LB>(static_cast<unsigned>(grp.k[i]),
                                    one_exp ? e : exp_at(erow, col + i, bs_log2));
  return out;
}

template <class L, typename CodeT, int Q>
__global__ void __launch_bounds__(kDotThreads, 2)
    block_dots_partial(const CodeT* __restrict__ codes, const int* __restrict__ exps,
                       const ValueT<L>* __restrict__ W, ValueT<L>* __restrict__ partial,
                       long long M, long long n_seg, int q, long long chunk_cols,
                       long long nchunks, int bs_log2) {
  using T = ValueT<L>;
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));   // code bits
  constexpr int G = 16 / static_cast<int>(sizeof(CodeT));   // codes per 16-byte load
  constexpr int kStep = kLanesPerRow * G;                    // columns per row per step
  constexpr int S = stage_cols<Q>();                         // columns per W stage
  constexpr int kSteps = S / kStep;                          // steps per W stage
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));     // W values per copy
  constexpr int R = kRowsPerLane;
  constexpr int kSafeExp = LB;    // an in-range exponent for rows past M
  constexpr int H = G * static_cast<int>(sizeof(T)) / 16;   // W copies per lane-step
  // W's sub-chunk, row b of W at ws[.][b], in 16-byte chunks; logical chunk
  // k sits at k ^ ((k >> 3) & (H - 1)), so that the eight lanes of a row,
  // H chunks apart, hit eight distinct bank groups on every load (the four
  // rows of a warp read the same chunks)
  __shared__ __align__(16) T ws[kStages * Q * S];
  const int tid = threadIdx.x;
  const int sl = tid & (kLanesPerRow - 1);
  const long long rbase = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                          (tid / kLanesPerRow);
  const long long chunk = blockIdx.y;
  const long long c0 = chunk * chunk_cols;
  const long long c1 = min(c0 + chunk_cols, n_seg);
  const int nstages = static_cast<int>((c1 - c0 + S - 1) / S);
  const int nsteps = static_cast<int>((c1 - c0) / kStep);
  const bool one_exp = (G >> bs_log2) <= 1;     // a lane's G codes share a block

  // this lane's rows, from the chunk's first column; offsets below are ints
  const uint4* crow[R];
  const int* erow[R];
  bool live[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long row = rbase + j * kRowSlots;
    live[j] = row < M;
    const long long rr = live[j] ? row : 0;
    crow[j] = reinterpret_cast<const uint4*>(codes + rr * n_seg + c0 + sl * G);
    erow[j] = exps + rr * (n_seg >> bs_log2) + (c0 >> bs_log2);
  }
  const uint4* wlane = reinterpret_cast<const uint4*>(ws) + sl * H;
  const int swz = ((sl * H) >> 3) & (H - 1);   // this lane's chunk swizzle

  // the rows b >= q of every stage stay zero (no copy writes them)
  for (int i = tid; i < kStages * Q * S; i += kDotThreads)
    if ((i / S) % Q >= q) ws[i] = T(0);

  // stage st of W -> ring slot st % kStages, one commit group per stage
  auto issue = [&](int st) {
    if (st < nstages) {
      const long long s0 = c0 + static_cast<long long>(st) * S;
      const int cnt = static_cast<int>(min(static_cast<long long>(S), c1 - s0));
      T* dst = ws + (st % kStages) * Q * S;
      for (int i = tid; i < q * (S / kVec); i += kDotThreads) {
        const int b = i / (S / kVec);
        const int k = i - b * (S / kVec);
        const int p = k ^ ((k >> 3) & (H - 1));
        if (k * kVec < cnt) cp_async16(dst + b * S + p * kVec, W + b * n_seg + s0 + k * kVec);
      }
    }
    cp_async_commit();
  };

  // code words of step t (read once: they bypass L1) and their block's
  // exponent, or zeros past the end
  auto fetch = [&](int t, uint4 (&g)[R], int (&e)[R]) {
    const bool more = t < nsteps;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool ok = live[j] && more;
      g[j] = ok ? ld_stream(crow[j] + t * (kStep / G)) : make_uint4(0, 0, 0, 0);
      e[j] = ok && one_exp ? __ldg(erow[j] + ((t * kStep + sl * G) >> bs_log2)) : kSafeExp;
    }
  };

  T acc[R][Q];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int b = 0; b < Q; ++b) acc[j][b] = T(0);

  // step t: decode the words in buf, refill buf with step t + 2, contract
  auto step = [&](int t, uint4 (&buf)[R], int (&ebuf)[R]) {
    const int u = t % kSteps;
    const int st = t / kSteps;
    if (u == 0) {
      cp_async_wait<1>();     // this thread's copies of stage st have landed
      __syncthreads();        // everyone's have; everyone is done with st - 1
      issue(st + 2);          // into the slot stage st - 1 used
    }
    T v[R][G];
    bool fast = one_exp;
#pragma unroll
    for (int j = 0; j < R; ++j) fast = fast && scaled_in_range<L, LB>(ebuf[j]);
    if (fast) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        union {
          uint4 w;
          CodeT k[G];
        } grp;
        grp.w = buf[j];
        const unsigned shi = scale_hi<L, LB>(ebuf[j]);
#pragma unroll
        for (int i = 0; i < G; ++i)
          v[j][i] = decode_scaled_fast<L, LB>(static_cast<unsigned>(grp.k[i]), shi);
      }
    } else {
      const long long col = c0 + static_cast<long long>(t) * kStep + sl * G;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        // rows past M hold zero words under an in-range exponent
        const Group<L, CodeT> g = decode_group<L, CodeT>(
            buf[j], ebuf[j], one_exp || !live[j], erow[j] - (c0 >> bs_log2), col, bs_log2);
#pragma unroll
        for (int i = 0; i < G; ++i) v[j][i] = g.v[i];
      }
    }
    fetch(t + 2, buf, ebuf);
    const uint4* wu = wlane + ((st % kStages) * Q * S + u * kStep) / kVec;
#pragma unroll
    for (int b = 0; b < Q; ++b) {
      union {
        uint4 u4[H];
        T w[G];
      } wv;
#pragma unroll
      for (int h = 0; h < H; ++h) wv.u4[h] = wu[b * (S / kVec) + (h ^ swz)];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < G; ++i) acc[j][b] = fma(v[j][i], wv.w[i], acc[j][b]);
    }
  };

  // two buffers in turn: while one step is decoded and contracted, the
  // loads of the next two are in flight
  uint4 bufA[R], bufB[R];
  int eA[R], eB[R];
  issue(0);
  issue(1);
  fetch(0, bufA, eA);
  fetch(1, bufB, eB);
  for (int t = 0; t < nsteps; t += 2) {
    step(t, bufA, eA);
    if (t + 1 < nsteps) step(t + 1, bufB, eB);
  }
  cp_async_wait<0>();
  // fold the eight lanes of each row: a fixed butterfly, lane 0's sum kept
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int b = 0; b < Q; ++b)
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        acc[j][b] += __shfl_xor_sync(0xffffffffu, acc[j][b], off);
    const long long row = rbase + j * kRowSlots;
    if (sl == 0 && live[j]) {
      T* out = partial + (row * nchunks + chunk) * q;
#pragma unroll
      for (int b = 0; b < Q; ++b)
        if (b < q) out[b] = acc[j][b];
    }
  }
}

// Y[r, b] = sum of partial[r, c, b] over the chunks c: one warp per (r, b),
// lane i summing chunks i, i + 32, ... in order, then a fixed shuffle tree
// (a thread walking all the chunks alone took ~90 us at the main shape).
constexpr int kFinishWarps = 8;
template <typename T>
__global__ void __launch_bounds__(kFinishWarps * 32)
    block_dots_finish(const T* __restrict__ partial, T* __restrict__ Y, long long M,
                      long long nchunks, int q) {
  const long long idx = static_cast<long long>(blockIdx.x) * kFinishWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= M * q) return;     // the whole warp
  const long long row = idx / q;
  const int b = static_cast<int>(idx - row * q);
  const T* src = partial + row * nchunks * q + b;
  T acc = T(0);
  for (long long c = lane; c < nchunks; c += 32) acc += src[c * q];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) Y[idx] = acc;
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
                 cudaStream_t s) {
  using T = ValueT<L>;
  const long long nchunks = (n_seg + chunk_cols - 1) / chunk_cols;
  const dim3 grid(static_cast<unsigned>((M + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned>(nchunks));
  block_dots_partial<L, CodeT, Q><<<grid, kDotThreads, 0, s>>>(
      static_cast<const CodeT*>(codes), exps, static_cast<const T*>(W),
      static_cast<T*>(partial), M, n_seg, q, chunk_cols, nchunks, bs_log2);
  block_dots_finish<T><<<static_cast<unsigned>((M * q + kFinishWarps - 1) / kFinishWarps),
                         kFinishWarps * 32, 0, s>>>(static_cast<const T*>(partial),
                                                    static_cast<T*>(Y), M, nchunks, q);
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
            long long M, long long n_seg, int q, long long chunk_cols, int bs_log2,
            cudaStream_t s) {
  if (q <= 4)
    launch_dots<L, CodeT, 4>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, s);
  else if (q <= 8)
    launch_dots<L, CodeT, 8>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, s);
  else
    launch_dots<L, CodeT, 16>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, s);
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
    case 8: return dots_q<L, unsigned char>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, s);
    case 16: return dots_q<L, unsigned short>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, s);
    case 32: return dots_q<L, unsigned int>(codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, s);
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
