// ELL sparse matrix-vector product for Hopper (sm_90a), with the operand
// dense or FRSZ2-coded: the operator SpMV of every GMRES step and residual.
//
// Replaces the TPU kernels `repro/kernels/ell_spmv.py::ell_spmv_2d`
// (pallas_call at :49) and `::ell_spmv_frsz2_2d` (pallas_call at :76).
// y (nr,) = ELL(vals (nr, w), cols (nr, w) int32) @ x, padding slots holding
// val 0 and col 0.  The coded operand is FRSZ2 codes (nb * bs,) + one
// exponent per block; each gathered entry is decoded in registers from its
// code and its block's exponent (`decode_bits`), so no decoded vector ever
// reaches device memory.
//
// What bounds it on this card: bytes.  At the paper's atmosmodd size
// (nr = 1,259,712, w = 7, f64) one call streams 70.5 MB of values and
// 35.3 MB of int32 columns, reads x (10.1 MB; 5.2 MB as frsz2_32 codes) and
// writes y (10.1 MB): about 126 MB, 38 us at 3.35 TB/s.  Two flops per
// slot are nothing beside that.
//
// What the design does about it:
//  * a block of 128 threads owns 128 consecutive rows.  Their (128, w) tile
//    of values and columns is contiguous, so the block reads it with
//    consecutive threads on consecutive slots (coalesced), in passes of
//    at most 32 slots per row.  Each thread gathers its slot's operand entry
//    through the read-only path (`__ldg`) and writes the product to shared
//    memory;
//  * then each thread sums its own row's products in slot order, starting
//    from 0, into a register: no atomics, no cross-thread reduction, the
//    same bits on every run, and the same bits as `kernels/ref.py::
//    ell_spmv_ref` (the products are rounded before they are added, so no
//    multiply-add is fused);
//  * the int32 columns are read as they are: nothing widens them.
//  * the operand's gathers of a banded operator land in a few MB around the
//    row band, which L2 (50 MB) holds.
// A block of q dense operands x (q, nc) -> y (q, nr) is one launch with
// grid (row tiles, q), the counterpart of `jax.vmap` over `ell_spmv_2d` in
// the JAX package's block-GMRES (`repro/solver/block.py:219`).  Each column
// re-reads vals and cols (q x 106 MB at the main-path size); reading them
// once for all q columns is later work.
#include <algorithm>

#include "frsz2_common.cuh"

namespace ell {

constexpr int kRows = 128;                 // rows (and threads) per block
constexpr int kSlots = 32;                 // slots per row staged at once
constexpr int kStride = kSlots + 1;        // padded: no bank conflicts

// Dense operand, already in the value type: column blockIdx.y of a (q, nc)
// block.
template <typename T>
struct DenseX {
  const T* x;
  long long nc;
  __device__ __forceinline__ T operator()(int c) const {
    return __ldg(x + blockIdx.y * nc + c);
  }
};

// FRSZ2-coded operand: the code of entry c and its block's exponent.
template <typename T, class L, typename CodeT>
struct CodedX {
  const CodeT* codes;
  const int* exps;
  int bs_log2;
  int l;
  __device__ __forceinline__ T operator()(int c) const {
    using U = typename L::U;
    const U u = frsz2::decode_bits<L>(static_cast<U>(__ldg(codes + c)),
                                      __ldg(exps + (c >> bs_log2)), l);
    return static_cast<T>(frsz2::as_value(u));
  }
};

template <typename T, class Load>
__global__ void __launch_bounds__(kRows)
    ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols, Load load,
                    T* __restrict__ y, long long nr, int w) {
  __shared__ T prod[kRows * kStride];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), nr - row0));
  const T* vtile = vals + row0 * w;
  const int* ctile = cols + row0 * w;
  T acc = T(0);
  for (int k0 = 0; k0 < w; k0 += kSlots) {
    const int ks = min(kSlots, w - k0);
    const int cnt = rows * ks;
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += kRows) {
      const int r = e / ks;
      const int k = e - r * ks;
      const long long idx = static_cast<long long>(r) * w + k0 + k;
      prod[r * kStride + k] = vtile[idx] * load(ctile[idx]);
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      const T* p = prod + threadIdx.x * kStride;
      for (int k = 0; k < ks; ++k) acc += p[k];
    }
  }
  if (threadIdx.x < rows) y[blockIdx.y * nr + row0 + threadIdx.x] = acc;
}

template <typename T, class Load>
void launch(const void* vals, const int* cols, Load load, void* y, long long nr, int w,
            cudaStream_t s, int q = 1) {
  const long long blocks = (nr + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(q));
  ell_spmv_kernel<T, Load><<<grid, kRows, 0, s>>>(
      static_cast<const T*>(vals), cols, load, static_cast<T*>(y), nr, w);
}

template <typename T, class L>
bool launch_coded(const void* vals, const int* cols, const void* codes, const int* exps,
                  void* y, long long nr, int w, int bs_log2, int l, cudaStream_t s) {
  switch (l) {
    case 8:
      launch<T>(vals, cols, CodedX<T, L, unsigned char>{
                    static_cast<const unsigned char*>(codes), exps, bs_log2, l}, y, nr, w, s);
      return true;
    case 16:
      launch<T>(vals, cols, CodedX<T, L, unsigned short>{
                    static_cast<const unsigned short*>(codes), exps, bs_log2, l}, y, nr, w, s);
      return true;
    case 32:
      launch<T>(vals, cols, CodedX<T, L, unsigned int>{
                    static_cast<const unsigned int*>(codes), exps, bs_log2, l}, y, nr, w, s);
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
  if (nr <= 0 || w <= 0 || nc <= 0 || q <= 0 || q > frsz2::kMaxGridY ||
      nr > (1LL << 31) * kRows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  switch (kind) {
    case frsz2::kF32:
      launch<float>(vals, c, DenseX<float>{static_cast<const float*>(x), nc}, y, nr, w, s, q);
      break;
    case frsz2::kF64:
      launch<double>(vals, c, DenseX<double>{static_cast<const double*>(x), nc}, y, nr, w, s, q);
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
  if (nr <= 0 || w <= 0 || nr > (1LL << 31) * kRows || bs_log2 < 0 || bs_log2 > 7)
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
