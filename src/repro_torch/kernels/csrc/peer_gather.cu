// A reduction over NVLink through peer memory, for Hopper (sm_90a): every
// rank's buffer gathered into every rank's memory and summed in rank order.
//
// Replaces no TPU kernel.  The JAX package runs MGS's second pass under
// `jax.lax.cond` with its psums inside the branch (`repro/solver/
// pipeline.py:118-132`); the port runs it in a CUDA graph IF node
// (`solver/graphs.py::device_if`), and CUDA does not take NCCL's
// collectives inside a conditional node's body.  So inside that body the
// pass's reductions go through this kernel (`dist/collectives.py::
// _peer_reduce`); the rest of the cycle stays on NCCL.
// `kernels/peer_gather.py` binds it.
//
// What it computes, on every rank: out[i] = 0 + v_0[i] + v_1[i] + ... +
// v_{P-1}[i], the sum in rank order that `collectives._sum_in_rank_order`
// takes over an all-gather, where v_q is rank q's buffer `src`:
//   kind 0 / 1: f32 / f64 values, summed in their type;
//   kind 2: the wire codes of `collectives.compressed_psum` (WIRE_SPEC:
//     l = 16 codes in blocks of 128, f32 values; `collectives._pack`'s
//     buffer: the codes as 32-bit words, then one int32 exponent a block),
//     each decoded (frsz2_common.cuh's decode_bits, the plain decode's
//     bits) and summed in f32, then written as f32 or f64 (`out_f64`).
// So the coded sum keeps compressed_psum's bits, and the plain one is the
// plain version's (it may differ from NCCL's all-reduce in the last bit).
//
// The symmetric region.  Each rank allocates one region with `cudaMalloc`
// outside any capture (`peer_gather_alloc`), the ranks swap their
// `cudaIpcMemHandle_t`s over the host and open each other's
// (`peer_gather_open`), so `peers[q]` is rank q's region in this process's
// address space (`peers[rank]` its own).  A buffer travels in C chunks
// (the region's, fixed when it is made, so that every call runs the same
// blocks).  A region holds
//     flags[P][C] (u64)   flags[q][c]: the last call whose chunk c rank q has put here
//     slots[2][P][slot]   slots[e & 1][q]: rank q's data of call e
//
// One launch of P x C blocks; block b = c P + q of rank r:
//   1. e = counters[b] + 1: the call's sequence number.  A graph replays its
//      arguments as they were captured, so the number cannot be a host
//      argument: it is a counter on the card that the kernel advances itself
//      (step 5), one a block, so that no block waits for another.
//   2. writes chunk c of `src` into slots[e & 1][r] of rank q's region over
//      NVLink;
//   3. publishes: every thread fences at system scope, then one thread
//      stores e into rank q's flags[r][c] with `st.release.sys`;
//   4. waits until every flag of its own region is >= e (`ld.acquire.sys`,
//      thread t spinning on flag t), then sums its share of the elements
//      over the P slots of slots[e & 1] in rank order, reading around L1
//      (`ld.global.cg`: other cards wrote them; the acquires and the block's
//      barrier order the reads after the flags);
//   5. counters[b] = e.
// The slots are double-buffered by the parity of e: a rank cannot start
// call e + 2 before every peer has finished reading call e, because it
// needs their flag for e + 1, which each raises only after its kernel of
// call e has ended (stream order).  A peer may be one call ahead, hence
// `>=` in step 4.
//
// The wait is bounded (`timeout_ns` of %globaltimer): past it the thread
// prints which peer it waited for and traps, so a rank whose peers never
// come (one that took the other branch, or stopped) ends in a CUDA error,
// not a hang.  All ranks take the same branch of the IF node only because
// its predicate comes from reductions whose results are bit-identical on
// every rank (NCCL's all-reduce, and this kernel's rank-order sums).
//
// What bounds it: latency.  The messages are MGS's second-pass reductions,
// (m + 1) f64 values (808 B at m = 100) or a block's (m + 1) p^2 (52 KB at
// p = 8): (P - 1) x nbytes a rank over NVLink at 450 GB/s each way is a
// fraction of a microsecond, against the launch and the flag round trip
// over the link, a few microseconds.
//
// Entry points return a CUDA error code, or an error code of their own:
// 1002 for an argument the kernel does not take.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

#include "frsz2_common.cuh"

namespace peer_gather {

constexpr int kThreads = 256;
constexpr int kBadArgument = 1002;
// WIRE_SPEC (dist/collectives.py): l = 16 codes, 128 to a block, f32 values
constexpr int kWireL = 16;
constexpr int kWireBsLog2 = 7;

// Bytes of the flags, rounded so that the slots start 256-byte aligned.
__host__ __device__ inline long long flags_bytes(int P) {
  return (static_cast<long long>(P) * 8 + 255) / 256 * 256;
}

__host__ __device__ inline long long region_bytes(int P, int C, long long slot_bytes) {
  return flags_bytes(P * C) + 2LL * P * slot_bytes;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Copy nbytes (a multiple of 4) by the block's threads: 16-byte words where
// both ends and the length allow it, else 4-byte ones.
__device__ __forceinline__ void block_copy(char* dst, const char* src, long long nbytes) {
  const bool wide = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                      static_cast<uintptr_t>(nbytes)) & 15) == 0;
  if (wide) {
    const long long n = nbytes / 16;
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
    for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
  } else {
    const long long n = nbytes / 4;
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll 4
    for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
  }
}

// Value i of a slot, read around L1: a value of kind 0 / 1, or the decoded
// code i of a kind-2 slot (`words`: the 32-bit words of its codes, after
// which come the block exponents).
template <int KIND>
struct Slot;

template <>
struct Slot<0> {
  using Acc = float;
  static __device__ __forceinline__ float at(const char* s, long long i, long long) {
    return __ldcg(reinterpret_cast<const float*>(s) + i);
  }
};

template <>
struct Slot<1> {
  using Acc = double;
  static __device__ __forceinline__ double at(const char* s, long long i, long long) {
    return __ldcg(reinterpret_cast<const double*>(s) + i);
  }
};

template <>
struct Slot<2> {
  using Acc = float;
  static __device__ __forceinline__ float at(const char* s, long long i, long long words) {
    const unsigned c = __ldcg(reinterpret_cast<const unsigned short*>(s) + i);
    const int emax = __ldcg(reinterpret_cast<const int*>(s) + words + (i >> kWireBsLog2));
    return frsz2::as_value(frsz2::decode_bits<frsz2::F32>(c, emax, kWireL));
  }
};

template <int KIND, typename Out>
__global__ void __launch_bounds__(kThreads)
    peer_reduce_kernel(const unsigned long long* __restrict__ peers, int rank, int P, int C,
                       const char* __restrict__ src, long long nbytes, long long slot_bytes,
                       long long n, long long words, Out* __restrict__ out,
                       unsigned long long* __restrict__ counters, long long timeout_ns) {
  using Acc = typename Slot<KIND>::Acc;
  const int b = blockIdx.x, q = b % P, c = b / P;
  __shared__ unsigned long long call;
  if (threadIdx.x == 0) call = counters[b] + 1;
  __syncthreads();
  const unsigned long long e = call;
  const long long slots = flags_bytes(P * C);
  const long long parity = static_cast<long long>(e & 1ULL);

  // 2-3: my chunk c into rank q's slot, then rank q's flag for it
  const long long chunk = (nbytes + 16LL * C - 1) / (16LL * C) * 16;
  const long long lo = min(nbytes, c * chunk), hi = min(nbytes, lo + chunk);
  char* peer = reinterpret_cast<char*>(peers[q]);
  block_copy(peer + slots + (parity * P + rank) * slot_bytes + lo, src + lo, hi - lo);
  __threadfence_system();
  __syncthreads();
  const char* own = reinterpret_cast<const char*>(peers[rank]);
  if (threadIdx.x == 0)
    store_release_sys(reinterpret_cast<unsigned long long*>(peer) + rank * C + c, e);
  // 4: every rank's flags in my region, then my share of the sums
  if (threadIdx.x < P * C) {
    const unsigned long long* flag = reinterpret_cast<const unsigned long long*>(own) + threadIdx.x;
    const unsigned long long t0 = now_ns();
    while (load_acquire_sys(flag) < e) {
      if (static_cast<long long>(now_ns() - t0) > timeout_ns) {
        printf("peer_gather: rank %d waited %lld ns for rank %d's call %llu; a peer took "
               "another branch or stopped\n",
               rank, timeout_ns, static_cast<int>(threadIdx.x) / C, e);
        __trap();
      }
    }
  }
  __syncthreads();
  const char* mine = own + slots + parity * P * slot_bytes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(b) * blockDim.x + threadIdx.x; i < n; i += stride) {
    Acc t = Acc(0);
    for (int p = 0; p < P; ++p) t = t + Slot<KIND>::at(mine + p * slot_bytes, i, words);
    out[i] = static_cast<Out>(t);
  }
  if (threadIdx.x == 0) counters[b] = e;  // 5
}

}  // namespace peer_gather

extern "C" int peer_gather_region_bytes(int P, int C, long long slot_bytes, long long* out) {
  if (P < 1 || C < 1 || P * C > peer_gather::kThreads || slot_bytes < 0 || slot_bytes % 256 != 0)
    return peer_gather::kBadArgument;
  *out = peer_gather::region_bytes(P, C, slot_bytes);
  return 0;
}

// A zeroed region of `bytes` on the current device, and its IPC handle
// (`handle`: 64 bytes).  The memset is waited for, so that no peer that
// opens the handle finds stale flags.
extern "C" int peer_gather_alloc(long long bytes, void** base, void* handle) {
  cudaError_t e = cudaMalloc(base, static_cast<size_t>(bytes));
  if (e != cudaSuccess) return e;
  e = cudaMemset(*base, 0, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *base);
  if (e != cudaSuccess) {
    cudaFree(*base);
    *base = nullptr;
  }
  return e;
}

extern "C" int peer_gather_open(const void* handle, void** base) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int peer_gather_close(void* base) { return cudaIpcCloseMemHandle(base); }

extern "C" int peer_gather_free(void* base) { return cudaFree(base); }

extern "C" int peer_gather_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

// The PCI bus id of device `dev` ("0000:18:00.0"), into `buf` of `len`.
extern "C" int peer_gather_bus_id(int dev, char* buf, int len) {
  return cudaDeviceGetPCIBusId(buf, len, dev);
}

// `*out`: whether device `dev` can write to the memory of the device whose
// PCI bus id is `bus` (1), or not (0): another device that peer access
// reaches, or the same device.  A bus id this process does not see gives 0.
extern "C" int peer_gather_can_access(int dev, const char* bus, int* out) {
  int other = -1;
  *out = 0;
  if (cudaDeviceGetByPCIBusId(&other, bus) != cudaSuccess) {
    cudaGetLastError();  // clear it: an unseen device is an answer, not a fault
    return 0;
  }
  if (other == dev) {
    *out = 1;
    return 0;
  }
  return cudaDeviceCanAccessPeer(out, dev, other);
}

// Kinds of `src`: 0 f32 values, 1 f64 values, 2 WIRE_SPEC codes of n values
// whose codes take `words` 32-bit words (`out_f64`: f64 sums, else f32).
// C: the region's chunks a buffer.
extern "C" int peer_gather_run(const void* peers, int rank, int P, int C, const void* src,
                               long long nbytes, long long slot_bytes, int kind, long long n,
                               long long words, int out_f64, void* out, void* counters,
                               long long timeout_ns, void* stream) {
  using namespace peer_gather;
  if (P < 1 || C < 1 || P * C > kThreads || rank < 0 || rank >= P || nbytes < 0 ||
      nbytes % 4 != 0 || nbytes > slot_bytes || slot_bytes % 256 != 0 || timeout_ns <= 0 || n < 0)
    return kBadArgument;
  const auto* pe = static_cast<const unsigned long long*>(peers);
  const char* s = static_cast<const char*>(src);
  auto* c = static_cast<unsigned long long*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(P * C), block(kThreads);
  if (kind == 0 && !out_f64 && nbytes == 4 * n) {
    peer_reduce_kernel<0, float><<<grid, block, 0, st>>>(
        pe, rank, P, C, s, nbytes, slot_bytes, n, 0, static_cast<float*>(out), c, timeout_ns);
  } else if (kind == 1 && out_f64 && nbytes == 8 * n) {
    peer_reduce_kernel<1, double><<<grid, block, 0, st>>>(
        pe, rank, P, C, s, nbytes, slot_bytes, n, 0, static_cast<double*>(out), c, timeout_ns);
  } else if (kind == 2 && words * 2 >= n && (words * 2) % (1 << kWireBsLog2) == 0 &&
             nbytes == 4 * (words + (words * 2 >> kWireBsLog2))) {
    if (out_f64)
      peer_reduce_kernel<2, double><<<grid, block, 0, st>>>(
          pe, rank, P, C, s, nbytes, slot_bytes, n, words, static_cast<double*>(out), c,
          timeout_ns);
    else
      peer_reduce_kernel<2, float><<<grid, block, 0, st>>>(
          pe, rank, P, C, s, nbytes, slot_bytes, n, words, static_cast<float*>(out), c,
          timeout_ns);
  } else {
    return kBadArgument;
  }
  return cudaGetLastError();
}
