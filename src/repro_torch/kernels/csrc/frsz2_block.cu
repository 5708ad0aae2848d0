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
// decoded basis of twice the bytes (2.64 ms; H100 80GB HBM3, 700 W); the
// first combine, a thread a column with 4-byte loads, took 2.79 ms.
//
// What the designs do about it (SASS and times in PERF.md):
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
//  * combine: a thread owns four consecutive columns, one 16-byte word of
//    codes a row at l = 32 (8 bytes at l = 16, 4 at l = 8) sharing one
//    exponent, decoded by the scaled decode in one FMA a code (decode_fma:
//    one range guard a word, the bit decode out of line), and walks the M
//    segment rows in order, decoding one row ahead of its fmas, with eight
//    rows' words and exponents in flight, copied by cp.async into a ring in
//    shared memory (a register ring of four rows left the 4 x q
//    accumulators too few registers: 128 a thread at two blocks an SM, and
//    measured slower in development); Y is staged in shared memory (128
//    rows x q, 64 at q > 8) and read as 16-byte broadcasts, each value
//    serving four columns; 4 x q accumulators in registers.  Each column's
//    sum keeps the first combine's order (one fma a row from 0), so it
//    gives the same bits;
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
constexpr int kColThreads = 256;   // combine: threads per block
constexpr int kCombineCols = 4;    // combine: consecutive columns a thread owns
constexpr int kCombineStages = 8;  // combine: rows of code words in flight a thread
// combine: rows of Y staged at once (the ring, its exponents and the Y tile
// within the 48 KB of static shared memory at Q = 16)
template <int Q>
__host__ __device__ constexpr int row_tile() {
  return Q > 8 ? 64 : 128;
}
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

// out (q, n_seg) = Y^T @ decode(V): a thread owns kCombineCols consecutive
// columns (one word of codes a row: 16 bytes at l = 32, 8 at l = 16, 4 at
// l = 8) and walks the M rows in order.  Its words and their exponents
// arrive by cp.async in a ring of kCombineStages rows in shared memory,
// each thread copying and reading its own slots (no barrier), so that many
// rows' loads are in flight without holding registers; each row is decoded
// (decode_fma) one row ahead of its fmas, so that the decode's latency
// hides behind the previous row's.  Y is staged row_tile<Q>() rows at a
// time in shared memory and read as 16-byte broadcasts: each Y value serves
// the thread's four columns.  ONE_EXP: the four columns share a codec
// block (bs >= 4); else each code takes its own exponent on the out-of-line
// path.  Every accumulator gets one fma a row, in row order, from 0: the
// sum of the first combine (a thread a column) bit for bit, since the
// scaled decode gives the bit decode's values.
template <class L, typename CodeT, int Q, bool ONE_EXP>
__global__ void __launch_bounds__(kColThreads, Q > 8 ? 1 : 2)
    block_combine_kernel(const CodeT* __restrict__ codes, const int* __restrict__ exps,
                         const ValueT<L>* __restrict__ Y, ValueT<L>* __restrict__ out,
                         int M, long long n_seg, int q, int bs_log2) {
  using T = ValueT<L>;
  using W = Word4<CodeT>;
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));   // code bits
  constexpr int C = kCombineCols;
  constexpr int S = kCombineStages;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));     // Y values per 16 bytes
  constexpr int kRowTile = row_tile<Q>();
  static_assert(kRowTile % S == 0, "a Y tile holds whole ring turns");
  __shared__ __align__(16) T ys[kRowTile][Q];
  __shared__ __align__(16) W ring[S][kColThreads];
  __shared__ int ering[S][kColThreads];
  const long long col = (static_cast<long long>(blockIdx.x) * kColThreads + threadIdx.x) * C;
  const bool live = col < n_seg;        // n_seg is a multiple of C: all four or none
  const long long nb = n_seg >> bs_log2;
  const W* crow = reinterpret_cast<const W*>(codes + (live ? col : 0));
  const int* erow = exps + ((live ? col : 0) >> bs_log2);
  const long long wstride = n_seg / C;  // words a row
  W* wmine = &ring[0][threadIdx.x];
  int* emine = &ering[0][threadIdx.x];

  // row r's word (and exponent) into ring slot r % S, one commit group a
  // row (empty past M)
  auto issue = [&](int r) {
    if (live && r < M) {
      cp_async_word<sizeof(W)>(wmine + (r % S) * kColThreads, crow + r * wstride);
      if (ONE_EXP) cp_async_word<4>(emine + (r % S) * kColThreads, erow + r * nb);
    }
    cp_async_commit();
  };

  // row r's values from ring slot k (its copies have landed)
  auto decode = [&](int k, int r, T (&v)[C]) {
    const W w = live ? wmine[k * kColThreads] : W{};
    const int e = live && ONE_EXP ? emine[k * kColThreads] : LB;
    if (ONE_EXP && fma_in_range<L, LB>(e)) {
      const FmaScale<L> sc = fma_scale<L, LB>(e);
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = decode_fma<L, LB>(code_of<CodeT>(w, c), sc);
    } else {
      const Quad<L> g = decode_quad<L, CodeT>(w, e, ONE_EXP, erow + r * nb, bs_log2,
                                              live ? C : 0);
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = g.v[c];
    }
  };

  T acc[C][Q];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int b = 0; b < Q; ++b) acc[c][b] = T(0);
#pragma unroll
  for (int k = 0; k < S; ++k) issue(k);

  // one row ahead: row r + 1 is decoded (its slot refilled) before row r's
  // fmas, so the decode's latency hides behind them
  T v[C];
  cp_async_wait<S - 1>();
  decode(0, 0, v);
  issue(S);
  for (int r0 = 0; r0 < M; r0 += S) {
    if (r0 % kRowTile == 0) {           // stage the tile of Y from row r0
      const int cnt = min(kRowTile, M - r0);
      __syncthreads();
      for (int e = threadIdx.x; e < kRowTile * Q; e += kColThreads) {
        const int r = e / Q;
        const int b = e - r * Q;
        ys[r][b] = r < cnt && b < q ? Y[static_cast<long long>(r0 + r) * q + b] : T(0);
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int r = r0 + k;
      if (r >= M) break;                // uniform across the block
      T vn[C] = {};
      if (r + 1 < M) {
        cp_async_wait<S - 1>();         // this thread's copies of row r + 1 have landed
        decode((k + 1) % S, r + 1, vn);
        issue(r + 1 + S);               // into the slots just read
      }
      const T* yrow = ys[r0 % kRowTile + k];
#pragma unroll
      for (int b = 0; b < Q; b += kVec) {
        union {
          uint4 u;
          T t[kVec];
        } yv;
        yv.u = *reinterpret_cast<const uint4*>(yrow + b);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c][b + j] = fma(yv.t[j], v[c], acc[c][b + j]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = vn[c];
    }
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int b = 0; b < Q; ++b) {
      if (b < q) {
        T* o = out + static_cast<long long>(b) * n_seg + col;
#pragma unroll
        for (int c = 0; c < C; c += kVec) {
          union {
            uint4 u;
            T t[kVec];
          } ov;
#pragma unroll
          for (int j = 0; j < kVec; ++j) ov.t[j] = acc[c + j][b];
          *reinterpret_cast<uint4*>(o + c) = ov.u;
        }
      }
    }
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
                    long long M, long long n_seg, int q, int bs_log2, cudaStream_t s) {
  using T = ValueT<L>;
  constexpr long long kCols = static_cast<long long>(kColThreads) * kCombineCols;
  const unsigned gx = static_cast<unsigned>((n_seg + kCols - 1) / kCols);
  auto k = bs_log2 >= 2 ? &block_combine_kernel<L, CodeT, Q, true>
                        : &block_combine_kernel<L, CodeT, Q, false>;
  k<<<gx, kColThreads, 0, s>>>(static_cast<const CodeT*>(codes), exps,
                               static_cast<const T*>(Y), static_cast<T*>(out),
                               static_cast<int>(M), n_seg, q, bs_log2);
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
               long long n_seg, int q, int bs_log2, cudaStream_t s) {
  if (q <= 4)
    launch_combine<L, CodeT, 4>(codes, exps, Y, out, M, n_seg, q, bs_log2, s);
  else if (q <= 8)
    launch_combine<L, CodeT, 8>(codes, exps, Y, out, M, n_seg, q, bs_log2, s);
  else
    launch_combine<L, CodeT, 16>(codes, exps, Y, out, M, n_seg, q, bs_log2, s);
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
    case 8: return combine_q<L, unsigned char>(codes, exps, Y, out, M, n_seg, q, bs_log2, s);
    case 16: return combine_q<L, unsigned short>(codes, exps, Y, out, M, n_seg, q, bs_log2, s);
    case 32: return combine_q<L, unsigned int>(codes, exps, Y, out, M, n_seg, q, bs_log2, s);
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

// out (q, n_seg) = Y^T @ decode(V).  codes/exps as frsz2_block_dots, Y (M, q);
// codes aligned to four codes (a word), out to 16 bytes.
int frsz2_block_combine(const void* codes, const void* exps, const void* Y, void* out,
                        long long M, long long n_seg, int q, int bs_log2, int kind, int l,
                        void* stream) {
  using namespace frsz2_block;
  if (M <= 0 || M > (1LL << 31) - kCombineStages - 1 || n_seg <= 0 || n_seg % 128 || q < 1 ||
      q > kMaxQ || bs_log2 < 0 || bs_log2 > 7 || (l != 8 && l != 16 && l != 32) ||
      reinterpret_cast<unsigned long long>(codes) % (l / 2) ||
      reinterpret_cast<unsigned long long>(out) % 16)
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
