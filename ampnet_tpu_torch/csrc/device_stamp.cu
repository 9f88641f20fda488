// One timestamp of the device's own clock, written in stream order.
//
// Replaces no TPU kernel: it was added so that a bucket graph (infer/tiled.py,
// _run_bucket) can say, per replay, how long its tiling and its forward took
// on the device. A CUDA event recorded inside a captured graph cannot serve:
// its timing is read on the host after the replay, and the next replay of the
// same graph overwrites it. The stamp goes instead into a tensor that leaves
// the graph with the labels, through the per-replay copy into pinned memory.
//
// One thread of one block reads %globaltimer (nanoseconds, the same clock on
// every SM) and stores it: 8 bytes, bound by the launch alone (a few
// microseconds a stamp, three stamps a bucket graph of ~8,000 nodes). The
// kernel runs after every kernel enqueued before it on the stream has ended,
// and before any enqueued after it starts, so consecutive stamps bracket the
// work between them.

#include <cuda_runtime.h>

namespace {

__global__ void device_stamp_kernel(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = t;
}

}  // namespace

// out: one 8-byte slot on the current device. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int device_stamp(unsigned long long* out, void* stream) {
  if (out == nullptr || ((unsigned long long)out & 7) != 0) return (int)cudaErrorInvalidValue;
  device_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}
