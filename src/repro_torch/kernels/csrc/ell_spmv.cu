// ELL sparse matrix-vector product for Hopper (sm_90a), with the operand
// dense or FRSZ2-coded: the operator SpMV of every GMRES step and residual.
//
// Replaces the TPU kernels `repro/kernels/ell_spmv.py::ell_spmv_2d`
// (pallas_call at :49) and `::ell_spmv_frsz2_2d` (pallas_call at :76).
// y (nr,) = ELL(vals (nr, w), cols (nr, w) int32) @ x, padding slots holding
// val 0 and col 0.  The coded operand is FRSZ2 codes (nb * bs,) + one
// exponent per block; each gathered entry is decoded in registers from its
// code and its block's exponent, so no decoded vector ever reaches device
// memory.
//
// What bounds it on this card: bytes and the latency of dependent loads.
// At the paper's atmosmodd size (nr = 1,259,712, w = 7, f64) one call
// streams 70.5 MB of values and 35.3 MB of int32 columns, reads x (10.1 MB;
// 5.2 MB as frsz2_32 codes) and writes y (10.1 MB): about 126 MB, 38 us at
// 3.35 TB/s.  Two flops per slot are nothing beside that.  Each product
// waits on a chain of loads: the row's columns, then the gathered entry
// (and, coded, its block's exponent), so the card needs many rows in
// flight.  The first design staged a 32-slot tile per 128 rows in
// shared memory (33.8 KB a block, at most 24 warps an SM), divided by the
// slot count per element and decoded each entry with the 64-bit bit
// decode: 72.9 / 79.6 us (dense / coded, H100 80GB HBM3, 700 W).
//
// What the design does about it (46.7 / 50.2 us dense / coded, against
// cuSPARSE's 61.8 / 61.9 us on the decoded operand):
//  * the suite's widths (w = 7, the 7-point stencils, and w = 27) are
//    compiled in: one warp owns 32 consecutive rows, and its (32, w) tiles
//    of values and columns, which are contiguous, arrive in shared memory
//    by 16-byte cp.async copies sized to w (10.75 KB a block of four warps
//    at w = 7, f64); the warp waits for its own copies only (no block
//    barrier), so residency is bound by registers, not shared memory;
//  * each lane then takes one row: its w columns and values from shared
//    memory (odd strides, no bank conflicts), every gather of a group of
//    up to 8 slots issued before the first product, no integer division;
//  * a coded operand decodes with the exact scaled decode
//    (frsz2_common.cuh: a mask, one DADD or I2F, one multiply by the
//    block's power of two, the sign), and a slot whose entry shares its
//    neighbour's codec block reuses that exponent (every exponent load is
//    issued before any is used, so none waits on another);
//  * every other width runs one thread per row, its slots read straight
//    from device memory (the block's rows are contiguous, so L1 serves
//    the neighbours);
//  * each row sums its products in slot order from 0, each product rounded
//    before it is added (_rn intrinsics, nothing fused): the same bits as
//    kernels/ref.py::ell_spmv_ref and the JAX package's gather sum, and the
//    same bits on every run;
//  * the operand's gathers of a banded operator land in a few MB around the
//    row band, which L2 (50 MB) holds.
// A block of q dense operands x (q, nc) -> y (q, nr) is one launch, the
// counterpart of `jax.vmap` over `ell_spmv_2d` in the JAX package's
// block-GMRES (`repro/solver/block.py:219`).  The first batched launch ran
// the single-operand kernel on a grid (row tiles, q), so every column
// re-read vals and cols: 8 x 126 MB at q = 8, 330 us, already at the card's
// bandwidth.  Now the grid covers the row tiles only: a warp stages its
// (32, w) tile once, as above, and each lane walks the q columns of its row
// kCols at a time, the w * kCols gathers of a group in flight together (28
// at w = 7, 32 at w = 27), each column summed in slot order from 0 as
// before, so every output bit is unchanged.  The matrix is read once (267 MB
// at q = 8 with x and y); the gathers of the columns land in q bands of x,
// which at q = 8 (81 MB) exceed L2.  117 us at q = 8, against a 79.7 us
// bound and cuSPARSE's 606 us (H100 80GB HBM3, 700 W).  Other widths loop
// over the columns the same way, one thread per row.  A single operand
// (q = 1) and the coded operand keep their kernels.
#include <algorithm>

#include "frsz2_common.cuh"

namespace ell {

constexpr int kWarps = 4;                  // tile kernel: warps per block
constexpr int kThreads = kWarps * 32;      // threads per block (both kernels)
constexpr int kGroup = 8;                  // slots gathered before they are summed
constexpr int kCols = 4;                   // batched: columns of a row walked together

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b) {
  if constexpr (sizeof(T) == 8) return __dmul_rn(a, b); else return __fmul_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T add_rn(T a, T b) {
  if constexpr (sizeof(T) == 8) return __dadd_rn(a, b); else return __fadd_rn(a, b);
}

// Dense operand, already in the value type.
template <typename T>
struct DenseX {
  const T* x;
  __device__ __forceinline__ T one(int c) const { return __ldg(x + c); }
  template <int K>
  __device__ __forceinline__ void gather(const int (&c)[K], T (&v)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __ldg(x + c[k]);
  }
};

// FRSZ2-coded operand: the code of entry c and its block's exponent,
// decoded by the scaled decode.  A slot whose entry lies in the same codec
// block as the previous slot's reuses that exponent (a stencil row's
// neighbours mostly do).
template <typename T, class L, typename CodeT>
struct CodedX {
  static constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));
  const CodeT* codes;
  const int* exps;
  int bs_log2;
  __device__ __forceinline__ T one(int c) const {
    return static_cast<T>(frsz2::decode_scaled<L, LB>(__ldg(codes + c),
                                                      __ldg(exps + (c >> bs_log2))));
  }
  template <int K>
  __device__ __forceinline__ void gather(const int (&c)[K], T (&v)[K]) const {
    unsigned code[K];
    int e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) code[k] = __ldg(codes + c[k]);
    // every load is issued before any is used: a slot that shares its
    // neighbour's block loads nothing and takes that exponent afterwards
    bool own[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int b = c[k] >> bs_log2;
      own[k] = k == 0 || b != (c[k - 1] >> bs_log2);
      e[k] = own[k] ? __ldg(exps + b) : 0;
    }
#pragma unroll
    for (int k = 1; k < K; ++k) e[k] = own[k] ? e[k] : e[k - 1];
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = static_cast<T>(frsz2::decode_scaled<L, LB>(code[k], e[k]));
  }
};

// A warp's tile (n elements of E, contiguous) into shared memory: 16-byte
// cp.async copies where the source is aligned, element copies for the rest.
template <typename E>
__device__ __forceinline__ void stage(const E* __restrict__ src, E* dst, int n, bool aligned,
                                      int lane) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));
  const int nv = aligned ? n / kPer : 0;
  for (int i = lane; i < nv; i += 32) frsz2::cp_async16(dst + i * kPer, src + i * kPer);
  for (int i = nv * kPer + lane; i < n; i += 32) dst[i] = src[i];
}

// Compile-time width W: one warp per 32 consecutive rows.  The warp's
// (32, W) tiles of values and columns are contiguous; they arrive in shared
// memory by cp.async, then each lane takes one row: its W columns and
// values from shared memory (odd strides: no bank conflicts), its operand
// entries gathered kGroup slots at a time, all loads in flight before the
// first product, and the products summed in slot order from 0.
template <typename T, class Load, int W>
__global__ void __launch_bounds__(kThreads)
    ell_tile_kernel(const T* __restrict__ vals, const int* __restrict__ cols, Load load,
                    T* __restrict__ y, long long nr, bool aligned) {
  __shared__ __align__(16) T vs[kWarps][32 * W];
  __shared__ __align__(16) int cs[kWarps][32 * W];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  if (row0 >= nr) return;                    // whole warps leave: no block barrier
  const int rows = static_cast<int>(min(32LL, nr - row0));
  stage(vals + row0 * W, vs[warp], rows * W, aligned, lane);
  stage(cols + row0 * W, cs[warp], rows * W, aligned, lane);
  frsz2::cp_async_commit();
  frsz2::cp_async_wait<0>();
  __syncwarp();
  if (lane >= rows) return;
  const T* vr = vs[warp] + lane * W;
  const int* cr = cs[warp] + lane * W;
  T acc = T(0);
#pragma unroll
  for (int k0 = 0; k0 < W; k0 += kGroup) {
    constexpr int kFull = W < kGroup ? W : kGroup;
    int c[kFull];
    T x[kFull];
#pragma unroll
    for (int k = 0; k < kFull; ++k) c[k] = k0 + k < W ? cr[k0 + k] : 0;
    load.template gather<kFull>(c, x);
#pragma unroll
    for (int k = 0; k < kFull; ++k)
      if (k0 + k < W) acc = add_rn(acc, mul_rn(vr[k0 + k], x[k]));
  }
  y[row0 + lane] = acc;
}

// Any other width: one thread per row, its slots read straight from device
// memory (the block's rows are contiguous, so L1 serves the neighbours).
template <typename T, class Load>
__global__ void __launch_bounds__(kThreads)
    ell_row_kernel(const T* __restrict__ vals, const int* __restrict__ cols, Load load,
                   T* __restrict__ y, long long nr, int w) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= nr) return;
  const T* vr = vals + row * w;
  const int* cr = cols + row * w;
  T acc = T(0);
  for (int k = 0; k < w; ++k) acc = add_rn(acc, mul_rn(__ldg(vr + k), load.one(__ldg(cr + k))));
  y[row] = acc;
}

// A block of q dense operands, compile-time width W: the warp's (32, W)
// tiles staged once, as in ell_tile_kernel; then each lane walks the q
// columns of its row kCols at a time, every gather of a group (W * kCols,
// in slot groups of kSlots) issued before its first product, each column's
// products summed in slot order from 0.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    ell_tile_batched_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                            const T* __restrict__ x, T* __restrict__ y, long long nr,
                            long long nc, int q, bool aligned) {
  constexpr int kSlots = W < kGroup ? W : kGroup;
  __shared__ __align__(16) T vs[kWarps][32 * W];
  __shared__ __align__(16) int cs[kWarps][32 * W];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  if (row0 >= nr) return;                    // whole warps leave: no block barrier
  const int rows = static_cast<int>(min(32LL, nr - row0));
  stage(vals + row0 * W, vs[warp], rows * W, aligned, lane);
  stage(cols + row0 * W, cs[warp], rows * W, aligned, lane);
  frsz2::cp_async_commit();
  frsz2::cp_async_wait<0>();
  __syncwarp();
  if (lane >= rows) return;
  const T* vr = vs[warp] + lane * W;
  const int* cr = cs[warp] + lane * W;
  const long long row = row0 + lane;
  for (int c0 = 0; c0 < q; c0 += kCols) {
    const int nq = min(kCols, q - c0);
    const T* xc = x + c0 * nc;
    T acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = T(0);
#pragma unroll
    for (int k0 = 0; k0 < W; k0 += kSlots) {
      int c[kSlots];
      T xv[kCols][kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) c[k] = k0 + k < W ? cr[k0 + k] : 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int k = 0; k < kSlots; ++k) xv[j][k] = j < nq ? __ldg(xc + j * nc + c[k]) : T(0);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (k0 + k < W) {
          const T v = vr[k0 + k];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[j] = add_rn(acc[j], mul_rn(v, xv[j][k]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < nq) y[(c0 + j) * nr + row] = acc[j];
  }
}

// A block of q dense operands, any other width: one thread per row, its
// slots read straight from device memory once per group of kCols columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ell_row_batched_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                           const T* __restrict__ x, T* __restrict__ y, long long nr, int w,
                           long long nc, int q) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= nr) return;
  const T* vr = vals + row * w;
  const int* cr = cols + row * w;
  for (int c0 = 0; c0 < q; c0 += kCols) {
    const int nq = min(kCols, q - c0);
    const T* xc = x + c0 * nc;
    T acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = T(0);
    for (int k = 0; k < w; ++k) {
      const T v = __ldg(vr + k);
      const int c = __ldg(cr + k);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < nq) acc[j] = add_rn(acc[j], mul_rn(v, __ldg(xc + j * nc + c)));
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < nq) y[(c0 + j) * nr + row] = acc[j];
  }
}

__host__ inline bool aligned16(const void* a, const void* b) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
void launch_batched(const void* vals, const int* cols, const void* x, void* y, long long nr,
                    int w, long long nc, int q, cudaStream_t s) {
  const T* v = static_cast<const T*>(vals);
  const T* xs = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  const bool aligned = aligned16(vals, cols);
  const unsigned grid = static_cast<unsigned>((nr + kThreads - 1) / kThreads);
  switch (w) {
    case 7:
      ell_tile_batched_kernel<T, 7><<<grid, kThreads, 0, s>>>(v, cols, xs, out, nr, nc, q,
                                                              aligned);
      break;
    case 27:
      ell_tile_batched_kernel<T, 27><<<grid, kThreads, 0, s>>>(v, cols, xs, out, nr, nc, q,
                                                               aligned);
      break;
    default:
      ell_row_batched_kernel<T><<<grid, kThreads, 0, s>>>(v, cols, xs, out, nr, w, nc, q);
  }
}

template <typename T, class Load>
void launch(const void* vals, const int* cols, Load load, void* y, long long nr, int w,
            cudaStream_t s) {
  const T* v = static_cast<const T*>(vals);
  T* out = static_cast<T*>(y);
  const bool aligned = aligned16(vals, cols);
  const unsigned grid = static_cast<unsigned>((nr + kThreads - 1) / kThreads);
  switch (w) {
    case 7:
      ell_tile_kernel<T, Load, 7><<<grid, kThreads, 0, s>>>(v, cols, load, out, nr, aligned);
      break;
    case 27:
      ell_tile_kernel<T, Load, 27><<<grid, kThreads, 0, s>>>(v, cols, load, out, nr, aligned);
      break;
    default:
      ell_row_kernel<T, Load><<<grid, kThreads, 0, s>>>(v, cols, load, out, nr, w);
  }
}

template <typename T, class L>
bool launch_coded(const void* vals, const int* cols, const void* codes, const int* exps,
                  void* y, long long nr, int w, int bs_log2, int l, cudaStream_t s) {
  switch (l) {
    case 8:
      launch<T>(vals, cols, CodedX<T, L, unsigned char>{
                    static_cast<const unsigned char*>(codes), exps, bs_log2}, y, nr, w, s);
      return true;
    case 16:
      launch<T>(vals, cols, CodedX<T, L, unsigned short>{
                    static_cast<const unsigned short*>(codes), exps, bs_log2}, y, nr, w, s);
      return true;
    case 32:
      launch<T>(vals, cols, CodedX<T, L, unsigned int>{
                    static_cast<const unsigned int*>(codes), exps, bs_log2}, y, nr, w, s);
      return true;
    default:
      return false;
  }
}

template <typename T>
bool dispatch_coded(const void* vals, const int* cols, const void* codes, const int* exps,
                    void* y, long long nr, int w, int bs_log2, int kind, int l,
                    cudaStream_t s) {
  switch (kind) {
    case frsz2::kF32:
      return launch_coded<T, frsz2::F32>(vals, cols, codes, exps, y, nr, w, bs_log2, l, s);
    case frsz2::kF64:
      return launch_coded<T, frsz2::F64>(vals, cols, codes, exps, y, nr, w, bs_log2, l, s);
    default:
      return false;
  }
}

}  // namespace ell

extern "C" {

// y (q, nr) = ELL(vals, cols) @ x for each of q operands.  vals (nr, w)
// and x (q, nc) of the value kind (0 = f32, 1 = f64); cols (nr, w) int32,
// every entry in [0, nc).
int ell_spmv(const void* vals, const void* cols, const void* x, void* y, long long nr,
             int w, long long nc, int q, int kind, void* stream) {
  using namespace ell;
  if (nr <= 0 || w <= 0 || nc <= 0 || q <= 0 ||
      nr > (1LL << 31) * kThreads)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  switch (kind) {
    case frsz2::kF32:
      if (q == 1)
        launch<float>(vals, c, DenseX<float>{static_cast<const float*>(x)}, y, nr, w, s);
      else
        launch_batched<float>(vals, c, x, y, nr, w, nc, q, s);
      break;
    case frsz2::kF64:
      if (q == 1)
        launch<double>(vals, c, DenseX<double>{static_cast<const double*>(x)}, y, nr, w, s);
      else
        launch_batched<double>(vals, c, x, y, nr, w, nc, q, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The same with the operand FRSZ2-coded: codes (nb * bs,) of width l,
// exps (nb,), decoded values of kind `code_kind` (0 = f32, 1 = f64) converted
// to the value kind `kind` before the product.
int ell_spmv_frsz2(const void* vals, const void* cols, const void* codes,
                   const void* exps, void* y, long long nr, int w, int bs_log2,
                   int code_kind, int l, int kind, void* stream) {
  using namespace ell;
  if (nr <= 0 || w <= 0 || nr > (1LL << 31) * kThreads || bs_log2 < 0 || bs_log2 > 7)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const int* e = static_cast<const int*>(exps);
  bool ok = false;
  switch (kind) {
    case frsz2::kF32:
      ok = dispatch_coded<float>(vals, c, codes, e, y, nr, w, bs_log2, code_kind, l, s);
      break;
    case frsz2::kF64:
      ok = dispatch_coded<double>(vals, c, codes, e, y, nr, w, bs_log2, code_kind, l, s);
      break;
    default:
      break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
