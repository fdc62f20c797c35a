// Device-timed stage mark for Hopper (sm_90a): one thread writes the card's
// global nanosecond timer into a row of a preallocated int64 stack.
//
// Replaces no TPU kernel. It was added for the port's recorder (trace.py
// of the package): the captured training step is one CUDA graph
// replayed many times, so no host clock can see where inside a replay the
// card's time goes. Six launches of this kernel inside the graph (start,
// synthesis, forward, backward, update, recorded) stamp each stage boundary
// as the stream reaches it. The JAX package's counterpart is the named
// scopes of biear_tpu/utils/profiler.py, which the TPU's own profiler reads.
// Contract:
//
//   r = *row;  if 0 <= r < n_rows:  marks[r * n_slots + slot] = %globaltimer
//
// row is a device counter (the chunk's row, which the graph advances), so a
// replay writes its own row without a host round trip; a row at or past the
// stack's end is not written.
//
// What bounds it on this card: launch latency. It moves 16 bytes and does
// no arithmetic; inside a graph a node costs about 2 us of the stream's
// time. It is one block of one thread, so it never holds more than one SM,
// and it reads the timer after the stream's previous node has finished
// (stream order), which is what makes two marks bracket a stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void trace_mark_kernel(long long* marks, const long long* row,
                                  int n_rows, int n_slots, int slot) {
  const long long r = *row;
  if (r < 0 || r >= n_rows) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  marks[r * n_slots + slot] = static_cast<long long>(now);
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its cudaError_t (0 = cudaSuccess). The
// caller checks that marks is an (n_rows, n_slots) int64 stack and row one
// int64 on the same card.
int trace_mark_launch(long long* marks, const long long* row, int n_rows,
                      int n_slots, int slot, void* stream) {
  if (n_rows <= 0 || n_slots <= 0 || slot < 0 || slot >= n_slots)
    return static_cast<int>(cudaErrorInvalidValue);
  trace_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      marks, row, n_rows, n_slots, slot);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
