// Random row gather for Hopper (sm_90a): out[n, :] = table[idx[n], :], int32.
//
// Replaces the TPU kernel examples/pallas_gather_microbench.py::make_pallas_gather
// (scalar-prefetched indices, one row DMA per index from a VMEM-resident
// table): the decoder's state-pack row gather shape, 65,536 random rows
// of a 56,432 x 16 int32 table.
//
// What bounds it on the H100: one dependent random load per row. At the
// microbench shape the table (3.6 MB) sits in L2 and the kernel moves
// 65,536 x (4 + 64 + 64) bytes = 8.7 MB, so latency and occupancy, not
// HBM bandwidth, set the time.
//
// Design: one thread per (row, 16-byte vector): a row of C = 16 ints is
// four int4 loads by four neighbouring threads, and neighbouring rows'
// stores are contiguous, so every store is a full coalesced 16-byte
// vector. Where C % 4 != 0 (or a pointer is not 16-byte aligned) one
// thread moves one int. Any N is taken. Indices are assumed in range, as
// in the Pallas kernel.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                  T* __restrict__ out, long long total, int width) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const long long n = t / width;
  out[t] = table[(size_t)idx[n] * width + (int)(t - n * width)];
}

}  // namespace

extern "C" int row_gather_launch(const int* table, const int* idx, int* out, int N, int C,
                                 int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = vec4 ? C / 4 : C;
  const long long total = (long long)N * width;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (vec4)
    row_gather_kernel<int4><<<blocks, THREADS, 0, s>>>(
        reinterpret_cast<const int4*>(table), idx, reinterpret_cast<int4*>(out), total, width);
  else
    row_gather_kernel<int><<<blocks, THREADS, 0, s>>>(table, idx, out, total, width);
  return static_cast<int>(cudaGetLastError());
}
