// FRSZ2 compress and decompress for Hopper (sm_90a), and the KV-cache write.
//
// Replaces the TPU kernels `repro/kernels/frsz2_kernel.py::compress_2d`
// (pallas_call at :113) and `::decompress_2d` (pallas_call at :75).  The
// cache write (frsz2_cache_write) is compress_2d as the serving cache calls
// it: K and V of one layer, cast, coded and scattered to their positions.
//
// What bounds them on this card: bytes.  Per value, compress reads the value
// (8 B for f64) and writes an l-bit code plus 4/bs B of exponent; decompress
// does the reverse.  The bit work (a block max, a few shifts, one clz) is
// tens of integer operations per value, under the card's integer rate for
// the bytes moved once each thread moves 16 bytes at a time.
//
// The row codec (frsz2_compress / frsz2_decompress), rows of the
// (rows, npad) layout.  The first design took one value a thread and one row
// a blockIdx.y (rows over 65,535 in several launches), 2.0-2.4x its byte
// bound at a 1.26M-value f64 row on an H100.  This one:
// - a thread takes V consecutive values of a row: 4 f64, 8 f32 or 8
//   f16/bf16 in compress (two 16-byte loads in flight a thread for f64 and
//   f32, which measured faster than one), 16 bytes of values in
//   decompress; the codes leave by one vector store;
// - the block maximum exponent: in registers over the thread's values (each
//   of its blocks apart when bs < V), then a shuffle max over the bs / V
//   lanes that hold the block.  No shared memory, no barrier;
// - one flat grid-stride index over rows x ceil(npad / V) chunks, the grid
//   sized by the kernel's occupancy: any number of rows is one launch, and
//   many short rows share a thread block;
// - the ragged tail (col >= n) reads as zero, so its codes are zero; a chunk
//   that is not whole, or whose pointer is not aligned to its vector (a row
//   view at an offset, n not a multiple of V), takes element accesses;
// - decompress reads V codes as one vector and each block exponent once,
//   decodes by the exact scaled decode (f32/f64, frsz2_common.cuh; the bit
//   decode outside its range and for 16-bit values) and writes 16 bytes.
//
// The cache write (frsz2_cache_write): K and V of one layer, (B, T, Hkv, D)
// by strides in f32, f16 or bf16 (D <= 128), into the layer's (B, Hkv, S, D)
// codes and (B, Hkv, S) uint8 exponents at positions lengths[b] + t (mod
// ring), in one launch.  Before, a decode step's write of one layer took 16
// launches (cast, copy to rows, compress, exponents narrowed, index
// copies), each a few microseconds of a host-bound step; the prefill's read
// and wrote each K/V three times around the kernel.  Here:
// - a (tensor, b, t, h) row of D = bs values (a cache block is a row) goes
//   to D / 8 lanes of bf16/f16 (D / 4 of f32): each lane loads 16 bytes of
//   values as one vector, so a warp codes two rows a pass at D = 128 in
//   bf16 (32 bytes a lane measured no faster), and widens them to f32 bits
//   in registers (bf16: a shift; f16: __half2float, exact), so the codes
//   equal those of the cast to f32 and the plain compress, by construction;
// - the block maximum is a shuffle max over the row's lanes; its first lane
//   writes the uint8 exponent, every lane its codes as one vector store;
// - the row index splits by multiply-high divisions (FastDiv), and the code
//   width is a template constant, which with the known sign of the shift
//   (encode_in_block) prunes encode_bits' dead branches: instructions, not
//   bytes, paced the first versions of this kernel at the prefill's
//   131,072 rows;
// - positions outside the cache are dropped, as the JAX package's scatter
//   drops them; with a ring, a row that a later row of the same write
//   overwrites (t < T - ring) is dropped too, which is what the prefill's
//   roll of the last ring positions gives; the prefill's padding past its
//   positions is cleared by the same launch (rows of zeros);
// - a grid-stride loop over the rows, the grid from the occupancy query.
//
// Layouts (row-major):
//   x     (rows, n)       value bits
//   codes (rows, npad)    npad = nb * bs, one code per element
//   exps  (rows, nb)      int32 block max exponents
#include <cstdint>

#include <cuda_fp16.h>

#include "frsz2_common.cuh"

namespace frsz2 {

constexpr int kThreads = 256;  // a multiple of every bs that divides 128

// ---------------------------------------------------------------------------
// vector accesses of N elements (N * sizeof(E) bytes, in words of <= 16)
// ---------------------------------------------------------------------------

template <int BYTES>
struct Word;
template <> struct Word<1> { using T = unsigned char; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

template <int N, typename E>
struct VecIO {
  static constexpr int kBytes = N * static_cast<int>(sizeof(E));
  static constexpr int kWord = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kWord>::T;
  union U {
    W w[kBytes / kWord];
    E e[N];
  };
  __device__ __forceinline__ static bool aligned(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & (kWord - 1)) == 0;
  }
  __device__ __forceinline__ static void load(const E* p, E (&v)[N]) {
    U u;
#pragma unroll
    for (int i = 0; i < kBytes / kWord; ++i) u.w[i] = reinterpret_cast<const W*>(p)[i];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = u.e[i];
  }
  __device__ __forceinline__ static void store(E* p, const E (&v)[N]) {
    U u;
#pragma unroll
    for (int i = 0; i < N; ++i) u.e[i] = v[i];
#pragma unroll
    for (int i = 0; i < kBytes / kWord; ++i) reinterpret_cast<W*>(p)[i] = u.w[i];
  }
};

// q / d for q < 2^31 by a multiply-high, an add and a shift (the divisor's
// "round-up" multiplier, Granlund and Montgomery): a row's index splits in
// a few instructions instead of the ~20 of each integer division.
struct FastDiv {
  unsigned mul, shift, d;
};
inline FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {static_cast<unsigned>(m), s, d};
}
__device__ __forceinline__ unsigned fdiv(unsigned q, const FastDiv& f) {
  return (__umulhi(q, f.mul) + q) >> f.shift;
}

// g = row * cpr + chunk; by the divisor's multiplier (cdiv) where the
// index is under 2^31
__device__ __forceinline__ void split_index(long long g, long long cpr, bool narrow,
                                            const FastDiv& cdiv, long long& row,
                                            long long& chunk) {
  if (narrow) {
    const unsigned r = fdiv(static_cast<unsigned>(g), cdiv);
    row = r;
    chunk = static_cast<long long>(static_cast<unsigned>(g) - r * cdiv.d);
  } else {
    row = g / cpr;
    chunk = g - row * cpr;
  }
}

// Threads of a grid-stride kernel that the card holds at once: the
// occupancy of `kernel` at kThreads a block times the SMs (0 on an error,
// which the launch's cudaGetLastError() then reports).
template <typename Kernel>
long long resident_threads(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return static_cast<long long>(per_sm) * sms * kThreads;
}

// Blocks of a grid-stride launch over `work` threads' worth of items: at
// most one wave of resident blocks (per instantiation, queried once).
template <typename Kernel>
unsigned grid_for(Kernel kernel, long long work, long long& resident) {
  if (resident <= 0) resident = resident_threads(kernel);
  const long long cap = resident > 0 ? resident : kThreads;
  const long long t = work < cap ? work : cap;
  return static_cast<unsigned>((t + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// the row codec
// ---------------------------------------------------------------------------

// The code of a value of biased exponent e in a block of max exponent
// emax >= e: encode_bits with e given as emax - k, k = max(emax - e, 0) (the
// same e), so that the compiler sees the shift's sign and drops the branch
// of a negative one.
template <class L, bool NEAREST, int LB>
__device__ __forceinline__ typename L::U encode_in_block(typename L::U sign, int e,
                                                         typename L::U sig, int emax) {
  const int k = max(emax - e, 0);
  return encode_bits<L, NEAREST>(sign, emax - k, sig, emax, LB);
}

// The block max exponent of each of the V values of a thread: in registers
// over each bs-group of its values, then over the bs / V lanes of a block.
template <int V>
__device__ __forceinline__ void block_max(int (&m)[V], int bs) {
#pragma unroll
  for (int off = 1; off < V; off <<= 1) {
    if (off < bs) {  // uniform
      int t[V];
#pragma unroll
      for (int i = 0; i < V; ++i) t[i] = max(m[i], m[i ^ off]);
#pragma unroll
      for (int i = 0; i < V; ++i) m[i] = t[i];
    }
  }
  for (int off = 1; off * V < bs; off <<= 1) {  // bs > V: m[] holds one value
    const int o = __shfl_xor_sync(0xffffffffu, m[0], off);
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = max(m[i], o);
  }
}

template <class L, typename CodeT, bool NEAREST, int V>
__global__ void __launch_bounds__(kThreads)
    compress_kernel(const typename L::Bits* __restrict__ x,
                    CodeT* __restrict__ codes, int* __restrict__ exps,
                    long long rows, long long n, long long npad, int bs_log2,
                    FastDiv cdiv) {
  using U = typename L::U;
  using Bits = typename L::Bits;
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));   // l: aligned codes
  const int bs = 1 << bs_log2;
  const long long cpr = (npad + V - 1) / V;
  const long long total = rows * cpr;
  const long long nb = npad >> bs_log2;
  const bool narrow = total < (1LL << 31);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // warp-aligned bases: a block's bs / V lanes are one aligned lane segment
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31u);
       base < total; base += stride) {
    const long long g = base + (threadIdx.x & 31);
    const bool live = g < total;
    long long row = 0, chunk = 0;
    if (live) split_index(g, cpr, narrow, cdiv, row, chunk);
    const long long col = chunk * V;
    const Bits* xp = x + row * n + col;
    Bits b[V];
    if (live && col + V <= n && VecIO<V, Bits>::aligned(xp)) {
      VecIO<V, Bits>::load(xp, b);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) b[i] = (live && col + i < n) ? xp[i] : Bits(0);
    }
    U sign[V], sig[V];
    int e[V], m[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      split_bits<L>(static_cast<U>(b[i]), sign[i], e[i], sig[i]);
      m[i] = e[i];
    }
    block_max<V>(m, bs);
    if (!live) continue;

    CodeT c[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      c[i] = static_cast<CodeT>(encode_in_block<L, NEAREST, LB>(sign[i], e[i], sig[i], m[i]));
    CodeT* cp = codes + row * npad + col;
    if (col + V <= npad && VecIO<V, CodeT>::aligned(cp)) {
      VecIO<V, CodeT>::store(cp, c);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (col + i < npad) cp[i] = c[i];
    }
    int* ep = exps + row * nb;
    if (bs >= V) {
      if ((col & (bs - 1)) == 0) ep[col >> bs_log2] = m[0];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (((col + i) & (bs - 1)) == 0 && col + i < npad) ep[(col + i) >> bs_log2] = m[i];
    }
  }
}

// One code to value bits: the exact scaled decode for f32/f64 (bit-equal to
// decode_bits, which it takes outside its range), decode_bits for 16-bit
// values.
template <class L, typename CodeT>
__device__ __forceinline__ typename L::Bits decode_one(CodeT c, int emax) {
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));
  if constexpr (L::W == 64) {
    return static_cast<typename L::Bits>(
        __double_as_longlong(decode_scaled<L, LB>(static_cast<unsigned>(c), emax)));
  } else if constexpr (L::W == 32) {
    return __float_as_uint(decode_scaled<L, LB>(static_cast<unsigned>(c), emax));
  } else {
    return static_cast<typename L::Bits>(
        decode_bits<L>(static_cast<typename L::U>(c), emax, LB));
  }
}

template <class L, typename CodeT, int V>
__global__ void __launch_bounds__(kThreads)
    decompress_kernel(const CodeT* __restrict__ codes,
                      const int* __restrict__ exps,
                      typename L::Bits* __restrict__ out, long long rows,
                      long long n, long long npad, int bs_log2, FastDiv cdiv) {
  using Bits = typename L::Bits;
  const int bs = 1 << bs_log2;
  const long long cpr = (n + V - 1) / V;
  const long long total = rows * cpr;
  const long long nb = npad >> bs_log2;
  const bool narrow = total < (1LL << 31);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       g < total; g += stride) {
    long long row, chunk;
    split_index(g, cpr, narrow, cdiv, row, chunk);
    const long long col = chunk * V;
    const bool whole = col + V <= n;
    const CodeT* cp = codes + row * npad + col;
    CodeT c[V];
    if (whole && VecIO<V, CodeT>::aligned(cp)) {
      VecIO<V, CodeT>::load(cp, c);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) c[i] = col + i < n ? cp[i] : CodeT(0);
    }
    const int* ep = exps + row * nb;
    Bits v[V];
    if (bs >= V) {
      const int emax = __ldg(ep + (col >> bs_log2));
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = decode_one<L, CodeT>(c[i], emax);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        v[i] = decode_one<L, CodeT>(c[i], col + i < n ? __ldg(ep + ((col + i) >> bs_log2)) : 0);
    }
    Bits* op = out + row * n + col;
    if (whole && VecIO<V, Bits>::aligned(op)) {
      VecIO<V, Bits>::store(op, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (col + i < n) op[i] = v[i];
    }
  }
}

template <class L, typename CodeT, bool NEAREST, int V>
void launch_compress(const void* x, void* codes, int* exps, long long rows,
                     long long n, long long npad, int bs_log2,
                     cudaStream_t stream) {
  using Bits = typename L::Bits;
  static long long resident = 0;
  auto kernel = compress_kernel<L, CodeT, NEAREST, V>;
  // whole warps: a block's lanes must all reach the shuffles
  const long long cpr = (npad + V - 1) / V;
  const long long work = (rows * cpr + 31) / 32 * 32;
  kernel<<<grid_for(kernel, work, resident), kThreads, 0, stream>>>(
      static_cast<const Bits*>(x), static_cast<CodeT*>(codes), exps, rows, n,
      npad, bs_log2, fast_div(static_cast<unsigned>(cpr < (1LL << 31) ? cpr : 1)));
}

template <class L, typename CodeT>
void launch_decompress(const void* codes, const int* exps, void* out,
                       long long rows, long long n, long long npad, int bs_log2,
                       cudaStream_t stream) {
  using Bits = typename L::Bits;
  constexpr int V = 16 / static_cast<int>(sizeof(Bits));
  static long long resident = 0;
  auto kernel = decompress_kernel<L, CodeT, V>;
  const long long cpr = (n + V - 1) / V;
  kernel<<<grid_for(kernel, rows * cpr, resident), kThreads, 0, stream>>>(
      static_cast<const CodeT*>(codes), exps, static_cast<Bits*>(out), rows, n,
      npad, bs_log2, fast_div(static_cast<unsigned>(cpr < (1LL << 31) ? cpr : 1)));
}

// Values a thread: 32 bytes of f64 or f32 (two 16-byte loads in flight),
// 16 bytes of f16/bf16; a block spans at most a warp at every bs.
template <class L, typename CodeT, bool NEAREST>
void launch_compress_v(const void* x, void* codes, int* exps, long long rows,
                       long long n, long long npad, int bs_log2,
                       cudaStream_t s) {
  constexpr int V = sizeof(typename L::Bits) == 8 ? 4 : 8;
  launch_compress<L, CodeT, NEAREST, V>(x, codes, exps, rows, n, npad, bs_log2, s);
}

template <class L>
bool dispatch_compress(const void* x, void* codes, int* exps, long long rows,
                       long long n, long long npad, int bs_log2, int l,
                       int nearest, cudaStream_t s) {
  switch (l * 2 + (nearest ? 1 : 0)) {
    case 16: launch_compress_v<L, unsigned char, false>(x, codes, exps, rows, n, npad, bs_log2, s); return true;
    case 17: launch_compress_v<L, unsigned char, true>(x, codes, exps, rows, n, npad, bs_log2, s); return true;
    case 32: launch_compress_v<L, unsigned short, false>(x, codes, exps, rows, n, npad, bs_log2, s); return true;
    case 33: launch_compress_v<L, unsigned short, true>(x, codes, exps, rows, n, npad, bs_log2, s); return true;
    case 64:
      if constexpr (L::W < 32) return false;
      else { launch_compress_v<L, unsigned int, false>(x, codes, exps, rows, n, npad, bs_log2, s); return true; }
    case 65:
      if constexpr (L::W < 32) return false;
      else { launch_compress_v<L, unsigned int, true>(x, codes, exps, rows, n, npad, bs_log2, s); return true; }
    default: return false;
  }
}

template <class L>
bool dispatch_decompress(const void* codes, const int* exps, void* out,
                         long long rows, long long n, long long npad,
                         int bs_log2, int l, cudaStream_t s) {
  switch (l) {
    case 8: launch_decompress<L, unsigned char>(codes, exps, out, rows, n, npad, bs_log2, s); return true;
    case 16: launch_decompress<L, unsigned short>(codes, exps, out, rows, n, npad, bs_log2, s); return true;
    case 32:
      if constexpr (L::W < 32) return false;
      else { launch_decompress<L, unsigned int>(codes, exps, out, rows, n, npad, bs_log2, s); return true; }
    default: return false;
  }
}

// ---------------------------------------------------------------------------
// the KV-cache write
// ---------------------------------------------------------------------------

namespace cachew {

constexpr int kWarps = kThreads / 32;

// K (index 0) and V (1) of one layer
struct Args {
  const void* src[2];            // (B, T, Hkv, D) values, by strides
  long long sb[2], st[2], sh[2], sd[2];   // their strides in elements
  const int* lengths;            // (B,) first position of each row; null: 0
  void* codes[2];                // (B, Hkv, S, D) codes
  unsigned char* exps[2];        // (B, Hkv, S) exponents
  unsigned per;                  // rows of one tensor: B * T * Hkv
  unsigned pad_per;              // rows cleared in one tensor: B * Hkv * (S - clear_from)
  FastDiv hkv, t, npos;          // division by Hkv, by T, by S - clear_from
  int T, D, S, ring, clear_from;
};

// f32 bits of a value of kind KIND held in its storage bits: exact widening
template <int KIND>
__device__ __forceinline__ unsigned widen(unsigned bits) {
  if constexpr (KIND == kBF16) return bits << 16;
  else if constexpr (KIND == kF16) return __float_as_uint(__half2float(
      __ushort_as_half(static_cast<unsigned short>(bits))));
  else return bits;
}

// Bytes of K/V values a lane loads for its row (8 bf16 values, 4 f32):
// a row of D = 128 bf16 values is 16 lanes, a warp pass 2 rows
constexpr int kLaneBytes = 16;

// Lanes of a warp that code one row: LPR lanes of VPL values each
// (kLaneBytes of them), so a warp codes 32 / LPR rows a pass; rows by a
// grid-stride loop, the head fastest (the order of K/V in memory).  Rows
// past the K/V rows clear the cache's positions [clear_from, S): a row of
// zeros codes to zero codes and a zero exponent.  Every lane reaches the
// shuffles: a lane whose row is past the end or dropped loads and stores
// nothing.
template <int KIND, typename CodeT, int LPR>
__global__ void __launch_bounds__(kThreads) cache_write_kernel(Args a) {
  using In = typename std::conditional<KIND == kF32, unsigned, unsigned short>::type;
  constexpr int VPL = kLaneBytes / static_cast<int>(sizeof(In));
  constexpr int RPW = 32 / LPR;                      // rows a warp pass
  constexpr int LB = 8 * static_cast<int>(sizeof(CodeT));
  const int lane = threadIdx.x & 31;
  const int d0 = (lane % LPR) * VPL;
  const unsigned main_rows = 2 * a.per;
  const unsigned rows = main_rows + 2 * a.pad_per;
  const unsigned step = gridDim.x * kWarps * RPW;
  for (unsigned r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * RPW; r0 < rows;
       r0 += step) {
    const unsigned r = r0 + lane / LPR;
    const bool clear = r >= main_rows;
    int x;                               // 0: K, 1: V
    bool live;
    long long slot;                      // (b, h, pos) in the cache
    const In* src = nullptr;
    long long sd = 1;
    if (!clear) {
      x = r >= a.per;
      const unsigned q = r - (x ? a.per : 0u);
      const unsigned qh = fdiv(q, a.hkv);
      const unsigned h = q - qh * a.hkv.d;
      const unsigned b = fdiv(qh, a.t);
      const int t = static_cast<int>(qh - b * a.t.d);
      int pos = t + (a.lengths ? __ldg(a.lengths + b) : 0);
      live = true;
      if (a.ring > 0) {
        live = t >= a.T - a.ring;        // else overwritten by a later row
        pos %= a.ring;
        if (pos < 0) pos += a.ring;      // the floor modulo of the plain version
      }
      live = live && pos >= 0 && pos < a.S;  // outside the cache: dropped
      slot = static_cast<long long>(b * a.hkv.d + h) * a.S + pos;
      src = static_cast<const In*>(a.src[x]) + b * a.sb[x] + t * a.st[x] + h * a.sh[x];
      sd = a.sd[x];
    } else {
      unsigned p = r - main_rows;
      x = p >= a.pad_per;
      p -= x ? a.pad_per : 0u;
      const unsigned bh = fdiv(p, a.npos);
      live = r < rows;
      slot = static_cast<long long>(bh) * a.S + a.clear_from + (p - bh * a.npos.d);
    }
    In raw[VPL];
    if (!clear && live && sd == 1 && d0 + VPL <= a.D && VecIO<VPL, In>::aligned(src + d0)) {
      VecIO<VPL, In>::load(src + d0, raw);
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        raw[i] = !clear && live && d0 + i < a.D ? src[(d0 + i) * sd] : In(0);
    }
    int emax = 0;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      emax = max(emax, static_cast<int>((widen<KIND>(raw[i]) >> 23) & 0xffu));
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, off));
    if (!live) continue;

    CodeT c[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      unsigned sign, sig;
      int e;
      split_bits<F32>(widen<KIND>(raw[i]), sign, e, sig);
      c[i] = static_cast<CodeT>(encode_in_block<F32, true, LB>(sign, e, sig, emax));
    }
    CodeT* dst = static_cast<CodeT*>(a.codes[x]) + slot * a.D + d0;
    if (d0 + VPL <= a.D && VecIO<VPL, CodeT>::aligned(dst)) {
      VecIO<VPL, CodeT>::store(dst, c);
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (d0 + i < a.D) dst[i] = c[i];
    }
    if (d0 == 0) a.exps[x][slot] = static_cast<unsigned char>(emax);
  }
}

template <int KIND, typename CodeT, int LPR>
void launch(const Args& a, cudaStream_t s) {
  static long long resident = 0;
  auto kernel = cache_write_kernel<KIND, CodeT, LPR>;
  const long long lanes = (2LL * (a.per + a.pad_per) + 32 / LPR - 1) / (32 / LPR) * 32;
  kernel<<<grid_for(kernel, lanes, resident), kThreads, 0, s>>>(a);
}

// LPR: the lanes a row of D <= 128 values needs at kLaneBytes a lane, at
// least 4
template <int KIND>
bool dispatch_l(const Args& a, int l, cudaStream_t s) {
  constexpr int VPL = kLaneBytes / (KIND == kF32 ? 4 : 2);
  const int lpr = a.D <= 4 * VPL ? 4 : a.D <= 8 * VPL ? 8 : a.D <= 16 * VPL ? 16 : 32;
#define FRSZ2_CW(CT)                                    \
  switch (lpr) {                                        \
    case 4: launch<KIND, CT, 4>(a, s); return true;     \
    case 8: launch<KIND, CT, 8>(a, s); return true;     \
    case 16: launch<KIND, CT, 16>(a, s); return true;   \
    default: launch<KIND, CT, 32>(a, s); return true;   \
  }
  switch (l) {
    case 8: FRSZ2_CW(unsigned char)
    case 16: FRSZ2_CW(unsigned short)
    case 32: FRSZ2_CW(unsigned int)
    default: return false;
  }
#undef FRSZ2_CW
}

}  // namespace cachew

}  // namespace frsz2

extern "C" {

// Each entry point returns cudaGetLastError() right after its launch, or
// cudaErrorInvalidValue for arguments it has no kernel for.

int frsz2_compress(const void* x, void* codes, void* exps, long long rows,
                   long long n, long long npad, int bs_log2, int kind, int l,
                   int nearest, void* stream) {
  using namespace frsz2;
  if (rows <= 0 || npad <= 0 || bs_log2 < 0 || bs_log2 > 7) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* e = static_cast<int*>(exps);
  bool ok = false;
  switch (kind) {
    case kF32: ok = dispatch_compress<F32>(x, codes, e, rows, n, npad, bs_log2, l, nearest, s); break;
    case kF64: ok = dispatch_compress<F64>(x, codes, e, rows, n, npad, bs_log2, l, nearest, s); break;
    case kF16: ok = dispatch_compress<F16>(x, codes, e, rows, n, npad, bs_log2, l, nearest, s); break;
    case kBF16: ok = dispatch_compress<BF16>(x, codes, e, rows, n, npad, bs_log2, l, nearest, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int frsz2_decompress(const void* codes, const void* exps, void* out,
                     long long rows, long long n, long long npad, int bs_log2,
                     int kind, int l, void* stream) {
  using namespace frsz2;
  if (rows <= 0 || n <= 0 || bs_log2 < 0 || bs_log2 > 7) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(exps);
  bool ok = false;
  switch (kind) {
    case kF32: ok = dispatch_decompress<F32>(codes, e, out, rows, n, npad, bs_log2, l, s); break;
    case kF64: ok = dispatch_decompress<F64>(codes, e, out, rows, n, npad, bs_log2, l, s); break;
    case kF16: ok = dispatch_decompress<F16>(codes, e, out, rows, n, npad, bs_log2, l, s); break;
    case kBF16: ok = dispatch_decompress<BF16>(codes, e, out, rows, n, npad, bs_log2, l, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// K and V of one layer into its coded cache (nearest rounding, f32 value
// bits, bs = D <= 128, uint8 exponents).  kind: the K/V value kind (f32,
// f16, bf16); strides in elements; lengths may be null (every row from 0);
// positions [clear_from, S) of every (b, h) are zeroed (none if >= S).
int frsz2_cache_write(const void* k, const void* v, long long ksb, long long kst,
                      long long ksh, long long ksd, long long vsb, long long vst,
                      long long vsh, long long vsd, const void* lengths,
                      void* kc, void* ke, void* vc, void* ve, int B, int T,
                      int Hkv, int D, int S, int ring, int clear_from, int kind,
                      int l, void* stream) {
  using namespace frsz2;
  const long long npos = clear_from < 0 ? -1 : S - static_cast<long long>(clear_from);
  if (B <= 0 || T < 0 || Hkv <= 0 || D <= 0 || D > 128 || S <= 0 || ring < 0 ||
      npos < 0 || T + npos == 0 || 2LL * B * Hkv * (T + npos) >= (1LL << 31))
    return cudaErrorInvalidValue;
  cachew::Args a{{k, v}, {ksb, vsb}, {kst, vst}, {ksh, vsh}, {ksd, vsd},
                 static_cast<const int*>(lengths), {kc, vc},
                 {static_cast<unsigned char*>(ke), static_cast<unsigned char*>(ve)},
                 static_cast<unsigned>(B * T * Hkv),
                 static_cast<unsigned>(B * Hkv * npos), fast_div(Hkv),
                 fast_div(T > 0 ? static_cast<unsigned>(T) : 1u),
                 fast_div(npos > 0 ? static_cast<unsigned>(npos) : 1u), T, D, S, ring,
                 clear_from};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (kind) {
    case kF32: ok = cachew::dispatch_l<kF32>(a, l, s); break;
    case kF16: ok = cachew::dispatch_l<kF16>(a, l, s); break;
    case kBF16: ok = cachew::dispatch_l<kBF16>(a, l, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
