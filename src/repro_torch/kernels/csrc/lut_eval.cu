// LUT evaluation of approximate arithmetic units for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lut_eval.py::lut_eval
// (body `_kernel`): the int32 gather out[i] = lut[(a[i] << wb) | b[i]],
// where the batched functional model folds each configuration's library
// choice into a as (entry << ea) | a.
//
// Bound on an H100: device-memory bytes. Each element reads a and b and
// writes out, 12 bytes, and does no arithmetic to speak of, so the floor
// is 12 bytes x M over 3.35 TB/s plus one read of the table. The TPU
// kernel kept the whole table in VMEM; here the table is read through the
// read-only path (__ldg): the small tables (17 KB constant-coefficient
// columns, 278 KB full mul8x4) stay in L1/L2 after first touch, and the
// largest (k-means' 24 MB sqrt18 stack) still fits the 50 MB L2. A
// grid-stride loop with a masked tail replaces the reference's padding of
// the ragged last block. An index outside the table is wrapped once if
// negative and then clamped, exactly as the plain version does, so an
// operand outside the table's domain never reads outside the table (the
// caller's domain guard reports it). A shared-memory variant for small
// tables is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks per SM on an H100

__global__ void __launch_bounds__(kThreads)
lut_eval_kernel(const int* __restrict__ lut, long long n_lut,
                const int* __restrict__ a, const int* __restrict__ b,
                int* __restrict__ out, long long m, int wb) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m;
       i += stride) {
    // int32 arithmetic with wraparound, as torch's and XLA's << and | do
    const int key = (int)(((unsigned)__ldg(a + i) << wb) |
                          (unsigned)__ldg(b + i));
    long long idx = key < 0 ? key + n_lut : key;
    idx = idx < 0 ? 0 : (idx >= n_lut ? n_lut - 1 : idx);
    out[i] = __ldg(lut + idx);
  }
}

}  // namespace

// Launches the gather on `stream`; returns cudaGetLastError() (0 = launched).
// The caller validates contiguous int32 tensors, n_lut >= 1 and 0 <= wb < 31.
extern "C" int lut_eval_launch(const int* lut, long long n_lut, const int* a,
                               const int* b, int* out, long long m, int wb,
                               void* stream) {
  if (m <= 0) return 0;
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lut_eval_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      lut, n_lut, a, b, out, m, wb);
  return (int)cudaGetLastError();
}
