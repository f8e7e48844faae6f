// The compiled solve's device-side outer loop (solver/compiled.py): a CUDA
// graph that runs a program's captured init graph, then its captured step
// graph inside a conditional WHILE node for as long as `loop_cond_kernel`
// says so. The counterpart of the JAX package's outer loop, a lax.while_loop
// whose condition (it < max_iter) & ~done.all() runs on the device
// (timeopt_tpu/solver/ilqr.py::_run_outer_loop). It replaces no Pallas
// kernel: the TPU evaluates that condition inside the jitted program, and
// here a graph launch has no other way to decide on the device whether to
// run another step, so that a solve queues with no read to the host.
//
//   loop graph: [init graph] -> loop_cond(first) -> WHILE(cond) { [step graph] -> loop_cond }
//
// loop_cond reads the program's done flags (B bools) and its counters
// ctr = int64 [it, cond, runs, steps]: it sets it to 0 (first) or it + 1,
// cond = it < max_iter && !(early_exit && all done), sets the WHILE node's
// condition to cond, and when the loop ends adds one to runs and it to
// steps, so that the host books a solve's kernel launches (init + it x
// step) when it reads the counters, never on the solve's path. The plain
// version is ops/cuda_loop.py::loop_condition.
//
// Bound: it reads B bytes and 32 bytes of counters and writes 32; at any B
// a solve takes, its time is a launch's latency (one block of 256 threads,
// a strided OR over the flags and one __syncthreads_or).
//
// Conditional nodes need CUDA >= 12.3 in the toolkit, the runtime and the
// driver.

#include <cuda_runtime.h>

#include <cstdio>

#if CUDART_VERSION < 12030
#error "loop_graph.cu needs CUDA 12.3 or later (conditional graph nodes)"
#endif

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) loop_cond_kernel(const unsigned char* __restrict__ done, long long B,
                                                             long long* __restrict__ ctr, int first, long long max_iter,
                                                             int early_exit, cudaGraphConditionalHandle handle,
                                                             int set_handle) {
  int pending = 0;
  for (long long i = threadIdx.x; i < B; i += kThreads) pending |= done[i] == 0;
  const int any_pending = __syncthreads_or(pending);
  if (threadIdx.x == 0) {
    const long long it = first ? 0 : ctr[0] + 1;
    const bool go = it < max_iter && !(early_exit && !any_pending);
    ctr[0] = it;
    ctr[1] = go;
    if (!go) {
      ctr[2] += 1;
      ctr[3] += it;
    }
    if (set_handle) cudaGraphSetConditional(handle, go ? 1u : 0u);
  }
}

const char* node_type_name(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeKernel: return "kernel";
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "child graph";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeWaitEvent: return "event wait";
    case cudaGraphNodeTypeEventRecord: return "event record";
    case cudaGraphNodeTypeExtSemaphoreSignal: return "external semaphore signal";
    case cudaGraphNodeTypeExtSemaphoreWait: return "external semaphore wait";
    case cudaGraphNodeTypeMemAlloc: return "memory allocation";
    case cudaGraphNodeTypeMemFree: return "memory free";
    case cudaGraphNodeTypeConditional: return "conditional";
    default: return "unknown";
  }
}

cudaError_t add_cond(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep, const unsigned char* done,
                     long long B, long long* ctr, int first, long long max_iter, int early_exit,
                     cudaGraphConditionalHandle handle) {
  int set_handle = 1;
  void* args[] = {&done, &B, &ctr, &first, &max_iter, &early_exit, &handle, &set_handle};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(kThreads);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, &dep, 1, &p);
}

cudaError_t add_while(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep,
                      cudaGraphConditionalHandle handle, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, graph, &dep, nullptr, 1, &p);
#else
  cudaError_t e = cudaGraphAddNode(node, graph, &dep, 1, &p);
#endif
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

const char* instantiate_result_name(int r) {
  switch (r) {
    case 0: return "success";
    case 1: return "error";
    case 2: return "invalid structure";
    case 3: return "node operation not supported";
    case 4: return "multiple devices not supported";
    case 5: return "conditional handle unused";
    default: return "unknown";
  }
}

}  // namespace

#define LOOP_CHECK(call, what)                                                              \
  do {                                                                                      \
    cudaError_t e_ = (call);                                                                \
    if (e_ != cudaSuccess) {                                                                \
      snprintf(err, err_len, "%s: %s (%s)", what, cudaGetErrorString(e_), cudaGetErrorName(e_)); \
      if (graph) cudaGraphDestroy(graph);                                                   \
      return int(e_);                                                                       \
    }                                                                                       \
  } while (0)

extern "C" {

// One launch of the condition on its own, outside any graph (no conditional
// handle to set): for holding the kernel against its plain version.
int loop_cond_launch(const void* done, long long B, void* ctr, int first, long long max_iter, int early_exit,
                     void* stream) {
  loop_cond_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(done), B, static_cast<long long*>(ctr), first, max_iter, early_exit, 0, 0);
  return int(cudaGetLastError());
}

// Build and instantiate the loop graph of a program on the current device:
// child-graph nodes of `init_graph` and (in the WHILE body) `step_graph`,
// which are cloned, so the caller keeps their memory pool alive for as long
// as the instantiated graph lives. On failure returns the CUDA error and
// writes what failed to err: the call, or the instantiation's result and the
// node it names (a node of the step graph that a conditional body does not
// take: kernels, memsets, memcopies, child graphs and empty nodes only).
int loop_graph_build(void* init_graph, void* step_graph, const void* done, long long B, void* ctr, long long max_iter,
                     int early_exit, void** exec_out, void** graph_out, char* err, int err_len) {
  cudaGraph_t graph = nullptr;
  const auto* done_p = static_cast<const unsigned char*>(done);
  auto* ctr_p = static_cast<long long*>(ctr);
  LOOP_CHECK(cudaGraphCreate(&graph, 0), "cudaGraphCreate");
  cudaGraphConditionalHandle handle;
  LOOP_CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0), "cudaGraphConditionalHandleCreate");
  cudaGraphNode_t init_node, first_node, while_node, step_node, next_node;
  cudaGraph_t body = nullptr;
  LOOP_CHECK(cudaGraphAddChildGraphNode(&init_node, graph, nullptr, 0, static_cast<cudaGraph_t>(init_graph)),
             "cudaGraphAddChildGraphNode (init graph)");
  LOOP_CHECK(add_cond(&first_node, graph, init_node, done_p, B, ctr_p, 1, max_iter, early_exit, handle),
             "cudaGraphAddKernelNode (loop_cond, first)");
  LOOP_CHECK(add_while(&while_node, graph, first_node, handle, &body), "cudaGraphAddNode (conditional WHILE)");
  LOOP_CHECK(cudaGraphAddChildGraphNode(&step_node, body, nullptr, 0, static_cast<cudaGraph_t>(step_graph)),
             "cudaGraphAddChildGraphNode (step graph, in the WHILE body)");
  LOOP_CHECK(add_cond(&next_node, body, step_node, done_p, B, ctr_p, 0, max_iter, early_exit, handle),
             "cudaGraphAddKernelNode (loop_cond, in the WHILE body)");
  cudaGraphExec_t exec = nullptr;
  cudaGraphInstantiateParams ip = {};
  ip.flags = 0;
  cudaError_t e = cudaGraphInstantiateWithParams(&exec, graph, &ip);
  if (e != cudaSuccess) {
    char where[256] = "no node named";
    if (ip.errNode_out != nullptr) {
      cudaGraphNodeType t;
      if (cudaGraphNodeGetType(ip.errNode_out, &t) == cudaSuccess) {
        if (t == cudaGraphNodeTypeKernel) {
          cudaKernelNodeParams kp;
          if (cudaGraphKernelNodeGetParams(ip.errNode_out, &kp) == cudaSuccess)
            snprintf(where, sizeof where, "at a kernel node (grid %u x %u x %u, block %u x %u x %u)", kp.gridDim.x,
                     kp.gridDim.y, kp.gridDim.z, kp.blockDim.x, kp.blockDim.y, kp.blockDim.z);
          else
            snprintf(where, sizeof where, "at a kernel node");
        } else {
          snprintf(where, sizeof where, "at a %s node (type %d)", node_type_name(t), int(t));
        }
      }
    }
    snprintf(err, err_len, "cudaGraphInstantiateWithParams (loop graph): %s (%s), result %d (%s), %s",
             cudaGetErrorString(e), cudaGetErrorName(e), int(ip.result_out),
             instantiate_result_name(int(ip.result_out)), where);
    cudaGraphDestroy(graph);
    return int(e);
  }
  *exec_out = exec;
  *graph_out = graph;
  return 0;
}

int loop_graph_launch(void* exec, void* stream) {
  return int(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

// Wait for the device's work (a launch of this graph may still be queued),
// then free the instantiated graph and its template.
int loop_graph_destroy(void* exec, void* graph) {
  cudaError_t e = cudaDeviceSynchronize();
  cudaError_t e1 = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return int(e != cudaSuccess ? e : e1 != cudaSuccess ? e1 : e2);
}

}  // extern "C"
