// Conditional "if" nodes inside a CUDA stream capture (CUDA 12.4+), for
// graph/captured.py::cond: a branch of a captured step that runs on the
// device only where a predicate tensor holds, with no host read.
//
// cond_begin, on a stream whose capture is active (the parent):
// - creates a conditional handle in the graph being captured;
// - records the predicate kernel (one thread: the handle <- *pred);
// - adds an IF node after it, the parent's capture now depending on it;
// - begins capturing a second stream (the child) into the node's body.
// The caller runs the body on the child, then cond_end ends that capture.
// The node's body then runs at each replay where *pred held when the
// predicate kernel ran. Nothing here synchronizes or reads the device.

#include <cuda_runtime.h>

namespace {

__global__ void cond_predicate_kernel(cudaGraphConditionalHandle handle,
                                      const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

int cond_begin(void* parent, void* child, const bool* pred, int mode) {
  cudaStream_t s = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                           &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cond_predicate_kernel<<<1, 1, 0, s>>>(handle, pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the dependencies now end in the predicate kernel
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(mode)));
}

int cond_end(void* child) {
  cudaGraph_t body;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body));
}

}  // extern "C"
