// Fused batched-dense GNN message passing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gnn_mp.py::gnn_mp
// (body `_kernel`): one GNN layer out = relu(A @ (H @ Wn) + H @ Ws + b) over
// a batch of small dense graphs, A (B,N,N) or one (N,N) shared by every
// graph (batch stride 0), H (B,N,F), Ws/Wn (F,Fo), b (Fo,), all fp32.
//
// Bound on an H100: fp32 operations. One engine chunk (B=512, N=32,
// F=Fo=300) is 6.21 GFLOP per layer against ~42 MB of activations, about
// 150 FLOP per byte, far above the fp32 ridge of 67 TFLOP/s over 3.35 TB/s
// (20 FLOP per byte). So the design keeps operand reuse on chip:
//   * one block owns the rows of whole graphs (64 rows: two graphs at
//     N=32) and a 64-column slice of Fo, so the aggregation by A never
//     needs another block's rows;
//   * H and both weight panels stream through shared memory in K-steps of
//     16; each thread accumulates a 4x4 tile of BOTH products (H@Ws and
//     H@Wn) in registers, so every staged value feeds 4 to 8 FMAs;
//   * the H@Wn tile then goes to shared memory and is aggregated by the
//     graphs' adjacency, also staged in shared memory, with no round trip
//     through device memory; bias and ReLU are the epilogue.
// A ragged batch and a ragged Fo are masked. Full fp32 (no TF32), so the
// result matches the plain version up to summation order. wgmma, TMA and
// TF32 tensor cores are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // graph nodes (rows) per block
constexpr int kCols = 64;      // output columns per block
constexpr int kStep = 16;      // K step staged per iteration
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxN = 64;

__global__ void __launch_bounds__(kThreads)
gnn_mp_kernel(const float* __restrict__ adj, long long adj_batch_stride,
              const float* __restrict__ h, const float* __restrict__ w_self,
              const float* __restrict__ w_nbr, const float* __restrict__ bias,
              float* __restrict__ out, int B, int N, int F, int Fo,
              int graphs_per_block) {
  __shared__ float hs[kStep][kRows + 1];   // H tile, k-major (+1: no bank
                                           // conflicts on the transpose)
  __shared__ float wss[kStep][kCols];
  __shared__ float wns[kStep][kCols];
  __shared__ float as[kRows * kMaxN];      // adjacency of the block's graphs
  __shared__ float msg[kRows][kCols];      // (H @ Wn) tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int g0 = blockIdx.y * graphs_per_block;
  const int G = min(graphs_per_block, B - g0);
  const int rows = G * N;                        // valid rows of this block
  const long long row0 = (long long)g0 * N;      // its first global row
  const int c0 = blockIdx.x * kCols;

  for (int i = tid; i < G * N * N; i += kThreads) {
    const int g = i / (N * N), r = i % (N * N);
    as[i] = adj[(long long)(g0 + g) * adj_batch_stride + r];
  }

  float own[4][4], nbr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) own[i][j] = nbr[i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += kStep) {
    for (int i = tid; i < kRows * kStep; i += kThreads) {
      const int r = i / kStep, kk = i % kStep, k = k0 + kk;
      hs[kk][r] = (r < rows && k < F) ? h[(row0 + r) * F + k] : 0.f;
    }
    for (int i = tid; i < kStep * kCols; i += kThreads) {
      const int kk = i / kCols, c = i % kCols;
      const int k = k0 + kk, col = c0 + c;
      const bool ok = k < F && col < Fo;
      wss[kk][c] = ok ? w_self[(long long)k * Fo + col] : 0.f;
      wns[kk][c] = ok ? w_nbr[(long long)k * Fo + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      float hv[4], sv[4], nv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = hs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sv[j] = wss[kk][tx + 16 * j];
        nv[j] = wns[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          own[i][j] = fmaf(hv[i], sv[j], own[i][j]);
          nbr[i][j] = fmaf(hv[i], nv[j], nbr[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) msg[ty + 16 * i][tx + 16 * j] = nbr[i][j];
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const int g = r / N;
    const float* arow = &as[(g * N + r % N) * N];
    const int m0 = g * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, col = c0 + c;
      if (col >= Fo) continue;
      float agg = 0.f;
      for (int q = 0; q < N; ++q) agg = fmaf(arow[q], msg[m0 + q][c], agg);
      out[(row0 + r) * Fo + col] = fmaxf(agg + own[i][j] + bias[col], 0.f);
    }
  }
}

}  // namespace

// Launches one layer on `stream`; returns cudaGetLastError() (0 = launched).
// The caller validates shapes: 1 <= N <= 64, contiguous fp32 tensors.
extern "C" int gnn_mp_launch(const float* adj, long long adj_batch_stride,
                             const float* h, const float* w_self,
                             const float* w_nbr, const float* bias,
                             float* out, int B, int N, int F, int Fo,
                             void* stream) {
  if (B <= 0 || Fo <= 0) return 0;
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  const int graphs_per_block = kRows / N;
  const dim3 grid((Fo + kCols - 1) / kCols,
                  (B + graphs_per_block - 1) / graphs_per_block);
  gnn_mp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      adj, adj_batch_stride, h, w_self, w_nbr, bias, out, B, N, F, Fo,
      graphs_per_block);
  return (int)cudaGetLastError();
}
