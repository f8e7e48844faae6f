// The device phase stamp of the port's tracing (utils/trace.py): one block
// that reads the device's global nanosecond clock (%globaltimer) and writes
// one row of a program's stamp log.
//
// A traced program (solver/compiled.py, built while tracing is on) launches
// this kernel at each phase boundary of its init and step bodies, so the
// stamps are kernel nodes of the captured init and step graphs and run
// inside the loop graph's conditional WHILE body, where an event record
// node cannot go and nothing may read back to the host. A program built
// with tracing off launches none.
//
// A row is five int64: (launch, iteration, code, t_ns, count).
//   launch     ctr[RUNS], the loops the program finished before this one:
//              the index of the launch the stamp belongs to (-1 without ctr);
//   iteration  ctr[IT], the outer step (the loop condition sets it before
//              each step), or -1 inside init (`init` != 0) or without ctr;
//   code       2 x phase + 1 at the phase's end (utils/trace.py::PHASES);
//   t_ns       %globaltimer when the kernel starts: every node before it in
//              the graph has finished;
//   count      with `done` (B bools), the problems not done: the pending
//              counter at a step's start; else -1.
// The row is claimed by atomicAdd on head[0]; once `capacity` rows are
// taken, a stamp writes nothing and adds one to head[1] (dropped).
//
// Bound: 40 bytes written and B bytes read; its time is a launch's latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 5;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(kThreads)
    trace_stamp_kernel(long long* __restrict__ rows, unsigned long long* __restrict__ head,
                       const long long* __restrict__ ctr, const unsigned char* __restrict__ done, long long capacity,
                       long long B, int init, long long code) {
  __shared__ unsigned long long t0;
  __shared__ int pending_total;
  if (threadIdx.x == 0) {
    t0 = global_ns();
    pending_total = 0;
  }
  __syncthreads();
  long long count = -1;
  if (done != nullptr) {
    int pending = 0;
    for (long long i = threadIdx.x; i < B; i += blockDim.x) pending += done[i] == 0;
    for (int o = 16; o > 0; o >>= 1) pending += __shfl_down_sync(0xffffffffu, pending, o);
    if ((threadIdx.x & 31) == 0) atomicAdd(&pending_total, pending);
    __syncthreads();
    count = pending_total;
  }
  if (threadIdx.x != 0) return;
  const unsigned long long row = atomicAdd(&head[0], 1ull);
  if (row >= static_cast<unsigned long long>(capacity)) {
    atomicAdd(&head[1], 1ull);
    return;
  }
  long long* r = rows + row * kFields;
  r[0] = ctr != nullptr ? ctr[2] : -1;
  r[1] = (init || ctr == nullptr) ? -1 : ctr[0];
  r[2] = code;
  r[3] = static_cast<long long>(t0);
  r[4] = count;
}

}  // namespace

extern "C" {

// One stamp on `stream` (captured when the stream is capturing). rows
// (capacity, 5) int64, head (2,) int64 [cursor, dropped]; ctr (4,) int64
// and done (B,) bool may be null.
int trace_stamp(void* rows, void* head, const void* ctr, const void* done, long long capacity, long long B, int init,
                long long code, void* stream) {
  const int threads = done != nullptr ? kThreads : 32;
  trace_stamp_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(rows), static_cast<unsigned long long*>(head), static_cast<const long long*>(ctr),
      static_cast<const unsigned char*>(done), capacity, B, init, code);
  return int(cudaGetLastError());
}

}  // extern "C"
