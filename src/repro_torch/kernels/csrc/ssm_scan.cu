// Diagonal linear recurrence (the SSM heads' scan) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (body `_kernel`): y_t = a_t * y_{t-1} + b_t over D float32 channels,
// from y0, returning every y_t and the final state.
//
// Bound on an H100: device-memory bytes. There is one multiply and one add
// per element against 12 bytes moved (a and b read once, ys written once;
// 8 bytes when `a` is shared across channels, below), so the floor is
// those bytes over 3.35 TB/s. At the LM slice's shape (T = 1024,
// D = B*H*Dh*N = 204,800) that is ~1.7 GB, ~0.5 ms per layer.
// The TPU kernel walked time in blocks of 128 on one core with the carry
// in VMEM; here time is a loop inside each thread and channels run in
// parallel, one thread per channel, so neighbouring threads load and
// store neighbouring addresses of each time row (coalesced). The loop
// loads 16 steps of a and b before it uses them, so each thread keeps 32
// loads in flight and the 204,800 threads of the slice hide the
// device-memory latency. Any T is taken: there is no block divisibility,
// hence no single-block fallback as in the TPU wrapper.
// `a` may be given compact, (T, D / rep) with channel c reading column
// c / rep: in the SSM the decay is one number per (batch, head) for all
// Dh*N channels of the head, so the (T, D) decay is never built.
// The update is a rounded multiply then a rounded add (no FMA), the
// plain version's arithmetic, so the two agree bit for bit. The outputs
// are written with streaming stores: nothing reads them again here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ a, long long a_cols, int rep,
                const float* __restrict__ b, const float* __restrict__ y0,
                float* __restrict__ ys, float* __restrict__ yf, int T,
                long long D) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  const float* ap = a + c / rep;
  const float* bp = b + c;
  float* yp = ys + c;
  float y = y0[c];
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(ap + (long long)(t + u) * a_cols);
      bv[u] = __ldg(bp + (long long)(t + u) * D);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      y = __fadd_rn(__fmul_rn(av[u], y), bv[u]);
      __stcs(yp + (long long)(t + u) * D, y);
    }
  }
  for (; t < T; ++t) {
    y = __fadd_rn(__fmul_rn(__ldg(ap + (long long)t * a_cols), y),
                  __ldg(bp + (long long)t * D));
    __stcs(yp + (long long)t * D, y);
  }
  yf[c] = y;
}

}  // namespace

// Launches the scan on `stream`; returns cudaGetLastError() (0 = launched).
// a: (T, a_cols) with a_cols * rep == D; b, ys: (T, D); y0, yf: (D,); all
// contiguous float32. The caller validates shapes and types.
extern "C" int ssm_scan_launch(const float* a, long long a_cols, int rep,
                               const float* b, const float* y0, float* ys,
                               float* yf, int T, long long D, void* stream) {
  if (D <= 0) return 0;
  const long long blocks = (D + kThreads - 1) / kThreads;
  ssm_scan_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      a, a_cols, rep, b, y0, ys, yf, T, D);
  return (int)cudaGetLastError();
}
