// One Givens step of the GMRES(m) cycle's least squares, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the jnp code of one Arnoldi step of the JAX
// package's device cycle (`repro/solver/gmres.py:159-191`), written as one
// kernel so that a CUDA graph of the cycle holds one node per step for it
// instead of O(j) tiny tensor ops (about 5,000 dependent nodes per cycle at
// m = 100).
//
// The state is one f64 vector laid out as `kernels/ref.py::givens_layout`
// says: R ((m+1) x m, row-major) | g (m+1) | est (m) | extra | cs (m) |
// sn (m) | alive.  Step j, while alive: apply the j earlier rotations to the
// new Hessenberg column [h_0..h_j, hj1], form rotation j, update g, write
// column j of R, cs[j], sn[j], est[j] = |g[j+1]| / b_norm, add fired*(j+1)
// to extra, and drop alive on a breakdown or once est[j] <= target.  Once
// dead, est[j] repeats est[j-1].
//
// What bounds it: latency.  The rotations form a chain of j dependent steps
// (each reads the column entry the previous one wrote), so one thread runs
// them; the column entries stay in registers.  A few microseconds at j = 100
// against a step's ~0.5 ms of basis traffic at full width.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic
// (`__dmul_rn`, `__dadd_rn`, `__ddiv_rn`, `__dsqrt_rn`), so nvcc cannot fuse
// a multiply and an add.  The rotations then round exactly as the host
// driver's Python floats do (`solver/gmres.py::_cycle`), est matches it bit
// for bit, and so does the iteration at which a cycle stops.
#include <cuda_runtime.h>

namespace gmres_step {

struct Layout {
  long long g, est, extra, cs, sn, alive;
  __device__ explicit Layout(int m) {
    g = static_cast<long long>(m + 1) * m;
    est = g + m + 1;
    extra = est + m;
    cs = extra + 1;
    sn = cs + m;
    alive = sn + m;
  }
};

template <typename T>
__global__ void givens_step_kernel(double* __restrict__ state, const T* __restrict__ h,
                                   const T* __restrict__ hj1_p, const T* __restrict__ w_pre_p,
                                   const unsigned char* __restrict__ fired_p,
                                   const T* __restrict__ b_norm_p, int j, int m,
                                   double target) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const Layout L(m);
  double* R = state;
  double* g = state + L.g;
  double* est = state + L.est;
  double* cs = state + L.cs;
  double* sn = state + L.sn;
  if (state[L.alive] == 0.0) {
    if (j > 0) est[j] = est[j - 1];
    return;
  }
  const double hj1 = static_cast<double>(*hj1_p);
  const double w_pre = static_cast<double>(*w_pre_p);
  const bool breakdown = hj1 <= __dadd_rn(__dmul_rn(1e-30, w_pre), 1e-300);

  // col[i] runs through registers: `cur` is col[i] after rotations 0..i-1
  double cur = static_cast<double>(h[0]);
  for (int i = 0; i < j; ++i) {
    const double a = cur;
    const double bb = static_cast<double>(h[i + 1]);
    const double c = cs[i], s = sn[i];
    R[static_cast<long long>(i) * m + j] = __dadd_rn(__dmul_rn(c, a), __dmul_rn(s, bb));
    cur = __dadd_rn(__dmul_rn(-s, a), __dmul_rn(c, bb));
  }
  const double a = cur, bb = hj1;
  const double denom = __dsqrt_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(bb, bb)));
  double c = 1.0, s = 0.0;
  if (denom > 0.0) {
    c = __ddiv_rn(a, denom);
    s = __ddiv_rn(bb, denom);
  }
  R[static_cast<long long>(j) * m + j] = __dadd_rn(__dmul_rn(c, a), __dmul_rn(s, bb));
  R[static_cast<long long>(j + 1) * m + j] = 0.0;
  const double gj = g[j];
  const double g1 = __dmul_rn(-s, gj);
  g[j] = __dmul_rn(c, gj);
  g[j + 1] = g1;
  cs[j] = c;
  sn[j] = s;
  const double resid = __ddiv_rn(fabs(g1), static_cast<double>(*b_norm_p));
  est[j] = resid;
  if (*fired_p) state[L.extra] = __dadd_rn(state[L.extra], static_cast<double>(j + 1));
  state[L.alive] = (!breakdown && resid > target) ? 1.0 : 0.0;
}

}  // namespace gmres_step

extern "C" {

// Step j of the cycle on `state` (f64, laid out as above).  h (j+1,), hj1,
// w_pre and b_norm are of the arithmetic type (kind 0 = f32, 1 = f64);
// fired is a bool (one byte).  One thread of one block.
int gmres_givens_step(void* state, const void* h, const void* hj1, const void* w_pre,
                      const void* fired, const void* b_norm, int j, int m,
                      double target, int kind, void* stream) {
  using namespace gmres_step;
  if (j < 0 || m <= 0 || j >= m) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* st = static_cast<double*>(state);
  const unsigned char* f = static_cast<const unsigned char*>(fired);
  switch (kind) {
    case 0:
      givens_step_kernel<float><<<1, 32, 0, s>>>(
          st, static_cast<const float*>(h), static_cast<const float*>(hj1),
          static_cast<const float*>(w_pre), f, static_cast<const float*>(b_norm), j, m,
          target);
      break;
    case 1:
      givens_step_kernel<double><<<1, 32, 0, s>>>(
          st, static_cast<const double*>(h), static_cast<const double*>(hj1),
          static_cast<const double*>(w_pre), f, static_cast<const double*>(b_norm), j, m,
          target);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
