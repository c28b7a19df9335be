// Conditional nodes in a captured CUDA graph: the port's counterpart of the
// lax.cond that the JAX package's jitted serving step runs on the device
// (cuda_optical_flow_2_tpu/models/streaming.py, the recovery check).  It
// replaces no Pallas kernel.  capture.cond calls these entries while a
// stream captures: a one-thread kernel sets two IF handles from a bool on
// the device (the predicate and its negation), and each branch is captured
// on a second stream into the body of its IF node, so a replay runs one
// branch and the host never reads the predicate.  If-else in one node needs
// CUDA 12.8; two IF nodes need 12.4, as PyTorch's own conditional nodes do.
#include <cuda_runtime.h>

__global__ void cond_set_kernel(cudaGraphConditionalHandle on_true,
                                cudaGraphConditionalHandle on_false, const bool* pred) {
  const unsigned int p = *pred ? 1u : 0u;
  cudaGraphSetConditional(on_true, p);
  cudaGraphSetConditional(on_false, 1u - p);
}

// A stream of its own (not one of PyTorch's pooled streams, one of which
// may be the capturing stream) to capture branch bodies on.
extern "C" int of2_stream_create(void** out) {
  cudaStream_t s = nullptr;
  const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return (int)err;
}

static cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                                const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
  const cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n);
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorStreamCaptureImplicit;
}

// On the capturing `stream`: create the handles of the true and the false
// IF node in the graph it captures into, and capture the kernel that sets
// them from *pred (a bool on the device).  handles: 2 x unsigned long long.
extern "C" int of2_cond_open(const void* pred, unsigned long long* handles, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle h[2];
  for (int i = 0; i < 2; ++i) {
    err = cudaGraphConditionalHandleCreate(&h[i], graph, 0, 0);
    if (err != cudaSuccess) return (int)err;
  }
  cond_set_kernel<<<1, 1, 0, s>>>(h[0], h[1], (const bool*)pred);
  handles[0] = h[0];
  handles[1] = h[1];
  return (int)cudaGetLastError();
}

// On the capturing `stream`: add an IF node on `handle` after the work
// captured so far, make it the stream's only dependency, and start
// capturing `body` (a stream that is not capturing) into the node's body.
extern "C" int of2_cond_begin_branch(unsigned long long handle, void* body, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body, params.conditional.phGraph_out[0],
                                            nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

// End the capture of a branch body begun by of2_cond_begin_branch.
extern "C" int of2_cond_end_branch(void* body) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture((cudaStream_t)body, &graph);
}
