// Conditional (IF) nodes inside a CUDA stream capture, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the device side of `jax.lax.cond` in the
// JAX package's cycles (`repro/solver/pipeline.py:124-132`, `:271-276`), so
// that a captured GMRES cycle runs MGS's second sweep only at the steps
// where it fires.  `solver/graphs.py::device_if` is its only caller.
//
// `graph_if_begin(stream, pred, body_stream)`, while `stream` captures:
//   1. creates a conditional handle in the graph being captured;
//   2. captures `set_condition` (one thread: the handle's value is the 0-d
//      bool `*pred` on the card, read when the graph replays);
//   3. adds an IF node after it, and makes it the capture's only
//      dependency, so what `stream` captures next runs after the node;
//   4. starts capturing `body_stream` into the node's body graph.
// `graph_if_end(body_stream)` ends that capture.  What `body_stream`
// captures in between runs at a replay only where `*pred` is true then.
//
// The entry points return a CUDA error code, or 1001 when `stream` is not
// capturing (a conditional node exists only inside a graph).
#include <cuda_runtime.h>

namespace graph_if {

constexpr int kNotCapturing = 1001;

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The graph `s` captures into and its current dependencies.
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr, n_deps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n_deps);
#endif
}

}  // namespace graph_if

extern "C" int graph_if_begin(void* stream, const void* pred, void* body_stream) {
  using namespace graph_if;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = capture_info(s, &status, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return kNotCapturing;

  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  e = capture_info(s, &status, &graph, &deps, &n_deps);  // now: set_condition
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

extern "C" int graph_if_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}
