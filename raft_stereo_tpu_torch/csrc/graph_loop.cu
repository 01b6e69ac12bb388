// The early-exit refinement loop as one CUDA graph, for NVIDIA Hopper
// (sm_90a, CUDA 12.4 or later).
//
// Replaces the device-side predicate of the JAX model's convergence-gated
// loop (raft_stereo_tpu/models/raft_stereo.py, the nn.while_loop of
// cond_exit / body_exit): the loop goes on while it < min_iters, or while
// it < limit and the worst batch member's mean |delta disparity| is at or
// above the threshold.  That loop is a lax.while_loop, whose predicate
// never leaves the TPU.  A CUDA graph has a fixed launch sequence, so the
// port builds the loop as a conditional WHILE node: its body is one
// refinement iteration (captured by PyTorch's stream capture, so every
// allocation of the iteration comes from the runner's graph pool, and
// added here as a child graph) followed by exit_predicate_kernel, which
// counts the iteration and sets the node's condition from the count, the
// iteration's delta and the bounds.  The condition's default is 1, so the
// body runs at least once, as min_iters >= 1 requires.  The whole pair is
// one graph: prologue (encoders, correlation, the carry's initial values)
// -> WHILE (iteration) -> epilogue (upsample, confidence, fetch cast), and
// a replay needs no host synchronisation.
//
// Bound: latency.  The predicate kernel reads 8 bytes and writes 4 with one
// thread; what it saves is the host round trip a loop on the host pays per
// iteration (a graph launch, an event wait and the card idle meanwhile).
//
// The graph entries take and return CUDA graph handles as opaque
// pointers; every entry returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

__global__ void exit_predicate_kernel(cudaGraphConditionalHandle handle,
                                      int* it, const float* delta,
                                      int min_iters, int limit,
                                      float threshold) {
  const int i = *it + 1;
  *it = i;
  const float d = *delta;
  // NaN compares false: a diverged iteration ends the loop, as in JAX
  const bool go = i < min_iters || (i < limit && d >= threshold);
  cudaGraphSetConditional(handle, go ? 1u : 0u);
}

extern "C" {

// Loads the predicate kernel's module: a kernel's first launch must not
// happen inside a capture.
int raft_graph_prepare() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, exit_predicate_kernel);
}

int raft_graph_create(void** graph) {
  return cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

// A conditional handle of `graph` whose value is 1 at every launch.
int raft_graph_while_handle(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h;
  cudaError_t e = cudaGraphConditionalHandleCreate(
      &h, static_cast<cudaGraph_t>(graph), 1, cudaGraphCondAssignDefault);
  *handle = h;
  return e;
}

// Adds a child-graph node (a copy of `child`) after `ndeps` nodes.
int raft_graph_add_child(void* graph, void* const* deps, int ndeps,
                         void* child, void** node) {
  return cudaGraphAddChildGraphNode(
      reinterpret_cast<cudaGraphNode_t*>(node),
      static_cast<cudaGraph_t>(graph),
      reinterpret_cast<const cudaGraphNode_t*>(deps), ndeps,
      static_cast<cudaGraph_t>(child));
}

// Adds a WHILE node on `handle` after `ndeps` nodes; *body is the node's
// body graph, to be filled by the caller.
int raft_graph_add_while(void* graph, void* const* deps, int ndeps,
                         unsigned long long handle, void** node,
                         void** body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(
      reinterpret_cast<cudaGraphNode_t*>(node),
      static_cast<cudaGraph_t>(graph),
      reinterpret_cast<const cudaGraphNode_t*>(deps), nullptr, ndeps, &p);
#else
  cudaError_t e = cudaGraphAddNode(
      reinterpret_cast<cudaGraphNode_t*>(node),
      static_cast<cudaGraph_t>(graph),
      reinterpret_cast<const cudaGraphNode_t*>(deps), ndeps, &p);
#endif
  if (e != cudaSuccess) return e;
  *body = p.conditional.phGraph_out[0];
  return cudaSuccess;
}

int raft_graph_instantiate(void* graph, void** exec) {
  return cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec),
                              static_cast<cudaGraph_t>(graph), 0);
}

int raft_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

int raft_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = f;
  }
  return e;
}

// The body's last node: it += 1, then the WHILE condition from it, delta
// and the bounds (one thread).
int raft_exit_predicate(unsigned long long handle, int* it,
                        const float* delta, int min_iters, int limit,
                        float threshold, void* stream) {
  exit_predicate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, it, delta, min_iters, limit, threshold);
  return cudaGetLastError();
}

}  // extern "C"
