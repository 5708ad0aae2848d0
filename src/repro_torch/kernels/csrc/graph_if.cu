// Conditional (IF) nodes inside a CUDA stream capture, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the device side of `jax.lax.cond` in the
// JAX package's cycles (`repro/solver/pipeline.py:124-132`, `:271-276`), so
// that a captured GMRES cycle runs MGS's second sweep only at the steps
// where it fires, and of the `alive` mask of their `fori_loop` cycle
// (`repro/solver/gmres.py:159-191`), so that a captured cycle runs no step
// after its last live one.  `solver/graphs.py::device_if` is its only
// caller.
//
// `graph_if_begin(stream, pred, pred_f64, body_stream)`, while `stream`
// captures:
//   1. creates a conditional handle in the graph being captured;
//   2. captures `set_condition` (one thread: the handle's value is whether
//      the 0-d `*pred` on the card is nonzero, read when the graph replays;
//      a bool, or an f64 where `pred_f64` is set, such as the `alive` slot
//      of a cycle's least-squares state);
//   3. adds an IF node after it, and makes it the capture's only
//      dependency, so what `stream` captures next runs after the node;
//   4. starts capturing `body_stream` into the node's body graph.
// `graph_if_end(body_stream)` ends that capture.  What `body_stream`
// captures in between runs at a replay only where `*pred` is nonzero then.
//
// Nested: where `stream` is `body_stream`, it is capturing an IF node's
// body, and the new node goes into that body.  A stream captures into one
// graph at a time, so step 4 suspends the outer body's capture, and
// `graph_if_end` resumes it after the new node: one body stream serves
// every level (its allocations stay in one pool, its cuBLAS workspace is
// the one it had).
//
// The entry points return a CUDA error code, 1001 when `stream` is not
// capturing (a conditional node exists only inside a graph), or 1002 for
// an end with no node open.
#include <cuda_runtime.h>

#include <vector>

namespace graph_if {

constexpr int kNotCapturing = 1001;
constexpr int kUnbalanced = 1002;

__global__ void set_condition(cudaGraphConditionalHandle handle, const void* pred, int pred_f64) {
  const bool holds = pred_f64 ? *static_cast<const double*>(pred) != 0.0
                              : *static_cast<const bool*>(pred);
  cudaGraphSetConditional(handle, holds ? 1u : 0u);
}

// An open node: for a nested one, the body it lies in and the node itself,
// where `graph_if_end` resumes that body's capture.
struct Open {
  cudaGraph_t outer;
  cudaGraphNode_t node;
};

std::vector<Open> open_nodes;

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

extern "C" int graph_if_begin(void* stream, const void* pred, int pred_f64, void* body_stream) {
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
  set_condition<<<1, 1, 0, s>>>(handle, pred, pred_f64);
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
  cudaStream_t bs = static_cast<cudaStream_t>(body_stream);
  Open o = {nullptr, nullptr};
  if (bs == s) {  // nested: suspend the outer body's capture
    cudaGraph_t outer = nullptr;
    e = cudaStreamEndCapture(s, &outer);
    if (e != cudaSuccess) return e;
    o = {outer, node};
  }
  e = cudaStreamBeginCaptureToGraph(bs, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e == cudaSuccess) open_nodes.push_back(o);
  return e;
}

extern "C" int graph_if_end(void* body_stream) {
  using namespace graph_if;
  if (open_nodes.empty()) return kUnbalanced;
  const Open o = open_nodes.back();
  open_nodes.pop_back();
  cudaStream_t bs = static_cast<cudaStream_t>(body_stream);
  cudaGraph_t body = nullptr;
  cudaError_t e = cudaStreamEndCapture(bs, &body);
  if (e != cudaSuccess || o.outer == nullptr) return e;
  // resume the outer body's capture, after the nested node
  return cudaStreamBeginCaptureToGraph(bs, o.outer, &o.node, nullptr, 1,
                                       cudaStreamCaptureModeThreadLocal);
}
