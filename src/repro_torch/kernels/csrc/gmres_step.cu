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
// sn (m) | alive | fired (m).  Step j, while alive: apply the j earlier
// rotations to the new Hessenberg column [h_0..h_j, hj1], form rotation j,
// update g, write column j of R, cs[j], sn[j], est[j] = |g[j+1]| / b_norm,
// fired[j], add fired*(j+1) to extra, and drop alive on a breakdown or once
// est[j] <= target; the step that drops it writes its est into est[j+1:m]
// too, which is what the dead steps would repeat, so that a captured cycle
// may skip them (its steps after the last live one never run).  Once dead,
// est[j] repeats est[j-1].
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
  long long g, est, extra, cs, sn, alive, fired;
  __device__ explicit Layout(int m) {
    g = static_cast<long long>(m + 1) * m;
    est = g + m + 1;
    extra = est + m;
    cs = extra + 1;
    sn = cs + m;
    alive = sn + m;
    fired = alive + 1;
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
  state[L.fired + j] = *fired_p ? 1.0 : 0.0;
  if (*fired_p) state[L.extra] = __dadd_rn(state[L.extra], static_cast<double>(j + 1));
  const bool alive = !breakdown && resid > target;
  state[L.alive] = alive ? 1.0 : 0.0;
  if (!alive)
    for (int i = j + 1; i < m; ++i) est[i] = resid;
}

// ---------------------------------------------------------------------------
// Block step j of block-GMRES (p right-hand sides share one block basis).
//
// Replaces no TPU kernel: it is the jnp code of one block step of the JAX
// package's block cycle (`repro/solver/block.py:140-166`, calling
// `_block_apply_prior` and `_block_triangularize` of `repro/solver/gmres.py`),
// one graph node per block step instead of ~64 j rotations as tensor ops
// (about 320,000 per cycle at m = 100, p = 8).
//
// State (`kernels/ref.py::block_givens_layout`): R ((m+1)p x mp, row-major)
// | G ((m+1)p x p) | est (m x p) | extra | cs (mp x p) | sn (mp x p) |
// alive.  Step j, while alive: the column slab is H ((j+1)p x p) over
// T (p x p) over zeros; apply the stored rotations of the jp = j*p earlier
// columns (rotation [c, k] acts on rows (c, c+p-k), in k order), then
// annihilate the band of rows jp..jp+2p-1 with rotations paired with the
// pivot row (zero-safe Givens, exact zeros below the diagonal, also applied
// to G), write the slab into columns jp..jp+p-1 of R, the rotations into
// cs/sn, est[j, b] = ||G[jp+p : jp+2p, b]|| / bn_safe[b] (squares summed in
// row order), add fired*(j+1) to extra, and drop alive on a total
// breakdown (every diagonal entry of T zero) or once every column is at
// target.  Once dead, est[j] repeats est[max(j-1, 0)].
//
// Design: one block of 32 threads; thread t < p owns slab column t.  The
// earlier rotations touch rows c..c+p of column c only, so each thread
// walks c upwards with a window of p+1 rows in shared memory (a ring): row
// c is final once column c's p rotations are applied, and row c+p+1 enters
// its slot.  The rotation of the band reduction is formed by the thread
// that owns the pivot column and broadcast through shared memory.
//
// What bounds it: latency.  The jp*p rotations of a column are a chain of
// dependent f64 operations (about 6,300 rotations at j = 99, p = 8), each
// a few shared-memory accesses and four multiplies and two adds, so one
// step at j = 99 takes a few hundred microseconds against the step's
// ~2.6 ms of basis bytes at full width.
//
// Rounding: as the scalar step, explicit `_rn` intrinsics throughout, so the
// kernel and `block_givens_step_ref` (Python floats) agree bit for bit.

constexpr int kMaxP = 16;

__device__ __forceinline__ void rotate(double& a, double& b, double c, double s) {
  const double na = __dadd_rn(__dmul_rn(c, a), __dmul_rn(s, b));
  b = __dadd_rn(__dmul_rn(-s, a), __dmul_rn(c, b));
  a = na;
}

__global__ void block_givens_step_kernel(double* __restrict__ state,
                                         const double* __restrict__ H,
                                         const double* __restrict__ Tm,
                                         const unsigned char* __restrict__ fired_p,
                                         const double* __restrict__ bn_safe, int j, int m,
                                         int p, double target) {
  __shared__ double win[kMaxP][kMaxP + 1];      // ring of p+1 rows per column
  __shared__ double Wc[kMaxP][2 * kMaxP];       // band rows jp..jp+2p-1, per column
  __shared__ double Gc[kMaxP][2 * kMaxP];       // G rows jp..jp+2p-1, per column
  __shared__ double rot[2];
  __shared__ int any_live;
  const int t = threadIdx.x;
  const bool own = t < p;
  const long long mp = static_cast<long long>(m) * p;
  const long long offG = (mp + p) * mp;
  const long long offEst = offG + (mp + p) * p;
  const long long offExtra = offEst + mp;
  const long long offCs = offExtra + 1;
  const long long offSn = offCs + mp * p;
  const long long offAlive = offSn + mp * p;
  double* R = state;
  double* G = state + offG;
  double* est = state + offEst;
  const double* cs = state + offCs;
  const double* sn = state + offSn;
  if (state[offAlive] == 0.0) {
    const int jj = j > 0 ? j - 1 : 0;
    if (own) est[static_cast<long long>(j) * p + t] = est[static_cast<long long>(jj) * p + t];
    return;
  }
  const int jp = j * p;
  const long long hrows = static_cast<long long>(j + 1) * p;
  // row r of slab column t
  auto src = [&](long long r) -> double {
    if (r < hrows) return H[r * p + t];
    if (r < hrows + p) return Tm[(r - hrows) * p + t];
    return 0.0;
  };

  if (own) {
    double* w = win[t];
    for (int r = 0; r <= p; ++r) w[r] = src(r);
    int s0 = 0;                                  // ring slot of row c
    for (int c = 0; c < jp; ++c) {
      double piv = w[s0];
      for (int k = 0; k < p; ++k) {
        int sl = s0 + p - k;
        if (sl > p) sl -= p + 1;
        const double cc = cs[static_cast<long long>(c) * p + k];
        const double ss = sn[static_cast<long long>(c) * p + k];
        rotate(piv, w[sl], cc, ss);
      }
      R[static_cast<long long>(c) * mp + jp + t] = piv;   // row c is final
      w[s0] = src(c + p + 1);
      s0 = s0 == p ? 0 : s0 + 1;
    }
    // the band: rows jp..jp+p from the ring, the rest from the slab
    for (int r = 0; r <= p; ++r) {
      int sl = s0 + r;
      if (sl > p) sl -= p + 1;
      Wc[t][r] = w[sl];
    }
    for (int r = p + 1; r < 2 * p; ++r) Wc[t][r] = src(jp + r);
    for (int r = 0; r < 2 * p; ++r) Gc[t][r] = G[static_cast<long long>(jp + r) * p + t];
  }
  __syncthreads();

  for (int k = 0; k < p; ++k) {
    for (int i = p; i > 0; --i) {
      const int r1 = k + i;
      if (t == k) {
        const double a = Wc[k][k], b = Wc[k][r1];
        const double denom = __dsqrt_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)));
        double c = 1.0, s = 0.0;
        if (denom > 0.0) {
          c = __ddiv_rn(a, denom);
          s = __ddiv_rn(b, denom);
        }
        rot[0] = c;
        rot[1] = s;
        double* csw = state + offCs + static_cast<long long>(jp + k) * p + (p - i);
        double* snw = state + offSn + static_cast<long long>(jp + k) * p + (p - i);
        *csw = c;
        *snw = s;
      }
      __syncthreads();
      if (own) {
        const double c = rot[0], s = rot[1];
        rotate(Wc[t][k], Wc[t][r1], c, s);
        rotate(Gc[t][k], Gc[t][r1], c, s);
      }
      __syncthreads();
    }
    if (t == k)
      for (int r = k + 1; r < 2 * p; ++r) Wc[t][r] = 0.0;
    __syncthreads();
  }

  if (t == 0) any_live = 0;
  __syncthreads();
  if (own) {
    for (int r = 0; r < 2 * p; ++r) R[static_cast<long long>(jp + r) * mp + jp + t] = Wc[t][r];
    for (long long r = jp + 2 * p; r < mp + p; ++r) R[r * mp + jp + t] = 0.0;
    for (int r = 0; r < 2 * p; ++r) G[static_cast<long long>(jp + r) * p + t] = Gc[t][r];
    double acc = 0.0;
    for (int r = p; r < 2 * p; ++r) acc = __dadd_rn(acc, __dmul_rn(Gc[t][r], Gc[t][r]));
    const double e = __ddiv_rn(__dsqrt_rn(acc), bn_safe[t]);
    est[static_cast<long long>(j) * p + t] = e;
    if (e > target) atomicOr(&any_live, 1);
  }
  __syncthreads();
  if (t == 0) {
    bool dead = true;
    for (int k = 0; k < p; ++k) dead = dead && fabs(Tm[k * p + k]) <= 1e-300;
    if (*fired_p) state[offExtra] = __dadd_rn(state[offExtra], static_cast<double>(j + 1));
    state[offAlive] = (!dead && any_live) ? 1.0 : 0.0;
  }
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

// Block step j of the block cycle on `state` (f64, laid out as above).
// H ((j+1)p x p), T (p x p) and bn_safe (p,) are f64; fired a bool (one
// byte).  One block of 32 threads.
int gmres_block_givens_step(void* state, const void* H, const void* T, const void* fired,
                            const void* bn_safe, int j, int m, int p, double target,
                            void* stream) {
  using namespace gmres_step;
  if (j < 0 || m <= 0 || j >= m || p < 1 || p > kMaxP) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  block_givens_step_kernel<<<1, 32, 0, s>>>(
      static_cast<double*>(state), static_cast<const double*>(H),
      static_cast<const double*>(T), static_cast<const unsigned char*>(fired),
      static_cast<const double*>(bn_safe), j, m, p, target);
  return cudaGetLastError();
}

}  // extern "C"
