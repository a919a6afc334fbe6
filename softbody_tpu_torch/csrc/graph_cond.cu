// Conditional bodies of captured frames: a CUDA-graph IF node recorded
// into the graph that a stream is capturing (ops/compiled.py,
// device_if).  The counterpart of lax.cond inside a jitted JAX frame:
// the device decides, at each replay, whether the body runs.
//
// sb_cond_begin(stream, pred, child):
//   - the graph `stream` captures, and its current dependencies
//     (cudaStreamGetCaptureInfo);
//   - a conditional handle of that graph, set at each replay by a
//     one-thread kernel captured on `stream` from the byte at `pred`
//     (device memory: nonzero runs the body);
//   - an IF node after it, which becomes `stream`'s only dependency;
//   - `child` begins capturing into the node's body graph (thread-local
//     mode, as the frame's own capture).
// The caller then launches the body's work on `child` and ends it with
// sb_cond_end(child).  Conditional nodes need CUDA 12.4 or later; the
// torch on the card (2.11) has no API for them, so the port records
// them here.
//
// sb_stream_create: a stream of the caller's own.  torch.cuda.Stream()
// hands out streams from a shared pool of 32, so the body stream could
// be the very stream a frame is being captured on, which then cannot
// begin a second capture.
//
// sb_stamp(slot, stream): one thread writes the card's %globaltimer (ns)
// into the int64 at `slot` when the stream gets there; under capture the
// launch is a graph node.  The tracer's device marks
// (utils/profiling.py, device_mark) time a captured frame's layers with
// it.

#include <cuda_runtime.h>

namespace {

__global__ void sb_stamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const unsigned char* pred) {
  cudaGraphSetConditional(handle, pred[0] != 0 ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, n);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" int sb_cond_begin(void* stream, const void* pred, void* child) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  set_condition<<<1, 1, 0, s>>>(handle, (const unsigned char*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)child, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int sb_cond_end(void* child) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)child, &body);
}

extern "C" int sb_stream_create(void** out) {
  cudaStream_t s;
  const cudaError_t err =
      cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = (void*)s;
  return (int)err;
}

extern "C" int sb_stamp(void* slot, void* stream) {
  sb_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)slot);
  return (int)cudaGetLastError();
}
