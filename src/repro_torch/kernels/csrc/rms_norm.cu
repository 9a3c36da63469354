// RMSNorm of the decoder blocks for Hopper (sm_90a):
// out = round(x * rsqrt(mean(x^2) + eps) * gamma) over each row of x.
//
// Replaces no TPU kernel: the JAX package leaves the norm to XLA, which
// fuses it into one pass. The port ran it as eight eager float32 passes
// (a cast, square, mean, add, rsqrt, two multiplies, a cast back), each
// over a float32 copy of the whole activation. Added because the prefill
// step's spans showed those passes at 28.3 ms of a ~228 ms call of
// Qwen2-VL-7B at 8,192 tokens (57 norms, ~0.50 ms each).
//
// Bound on an H100: device-memory bytes. A norm reads each row once and
// writes it once in the input's type, plus gamma once: at 8,192 x 3,584
// bf16 that is 117.4 MB, 35.1 us at 3.35 TB/s. The design moves no other
// byte:
//  - one block a row; each thread loads its share of the row into
//    registers (PER 16-byte vectors, neighbouring threads on neighbouring
//    addresses), sums the squares in the accumulation type (float32, or
//    float64 for float64 inputs), and the block reduces the sums with
//    warp shuffles and one shared-memory step. The row stays in registers
//    between the sum and the scaling, so it is read from device memory
//    once; the scaled row is written once, rounded once to x's type;
//  - the threads a row (a multiple of 32) and PER come from the width
//    (the wrapper's `plan`): at most 256 threads while 8 vectors a thread
//    hold the row, so several rows of one SM are in flight at once;
//  - gamma is read in its own type (x's, or the accumulation type when
//    the caller widened it) and widened in registers; it is small and
//    stays in L1/L2;
//  - a row whose start or width is not a multiple of 16 bytes (a width
//    with d % 8 != 0 in 2-byte types, a misaligned view) goes element by
//    element (PER elements a thread, the same coalesced order).
// The arithmetic is the plain version's, (x * r) * gamma with
// r = rsqrt(sum * (1 / d) + eps), each step rounded as it is there; only
// the sum of squares differs, taken in another order with each square
// fused into its add.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

template <typename E, int N>
struct alignas(sizeof(E) * N > 16 ? 16 : sizeof(E) * N) Pack {
  E v[N];
};

// an element's value in float (double for double) and a float (double)
// rounded to the nearest element, ties to even
template <typename E> struct Cvt;
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float wide(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float wide(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half narrow(float v) {
    return __float2half_rn(v);
  }
};
template <> struct Cvt<float> {
  static __device__ __forceinline__ float wide(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
};
template <> struct Cvt<double> {
  static __device__ __forceinline__ double wide(double v) { return v; }
  static __device__ __forceinline__ double narrow(double v) { return v; }
};

// rounded multiply, add and rsqrt, never contracted into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float rsqrt_of(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_of(double v) { return rsqrt(v); }

// the sum of every thread's `v`, returned to every thread of the block
template <typename A>
__device__ __forceinline__ A block_sum(A v) {
  __shared__ A warp_sums[kMaxThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = lane < n_warps ? warp_sums[lane] : (A)0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block a row. VEC elements a load (16 bytes, or 1 element), PER
// loads a thread: element j * VEC + e of the row, j = threadIdx.x +
// p * blockDim.x, lives in thread threadIdx.x's v[p].v[e].
template <typename T, typename G, typename A, int VEC, int PER>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const T* __restrict__ x, long long ld,
                const G* __restrict__ gamma, T* __restrict__ out, int d,
                A eps, A inv_d) {
  const T* xr = x + (long long)blockIdx.x * ld;
  T* yr = out + (long long)blockIdx.x * d;
  const int n_vec = d / VEC;
  Pack<T, VEC> v[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = threadIdx.x + p * blockDim.x;
    if (j < n_vec)
      v[p] = *reinterpret_cast<const Pack<T, VEC>*>(xr + j * VEC);
  }
  A ss = 0;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = threadIdx.x + p * blockDim.x;
    if (j < n_vec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const A f = (A)Cvt<T>::wide(v[p].v[e]);
        ss += f * f;
      }
    }
  }
  ss = block_sum(ss);
  const A r = rsqrt_of(add_rn(mul_rn(ss, inv_d), eps));
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = threadIdx.x + p * blockDim.x;
    if (j < n_vec) {
      const Pack<G, VEC> g =
          *reinterpret_cast<const Pack<G, VEC>*>(gamma + j * VEC);
      Pack<T, VEC> y;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        y.v[e] = Cvt<T>::narrow(
            mul_rn(mul_rn((A)Cvt<T>::wide(v[p].v[e]), r),
                   (A)Cvt<G>::wide(g.v[e])));
      *reinterpret_cast<Pack<T, VEC>*>(yr + j * VEC) = y;
    }
  }
}

template <typename T, typename G, typename A, int VEC>
int launch_vec(const void* x, long long rows, long long ld, const void* g,
               void* out, int d, double eps, int per, int threads,
               cudaStream_t s) {
  const A e = (A)eps, inv_d = (A)1 / (A)d;
  const dim3 grid((unsigned)rows), block((unsigned)threads);
  const T* xp = static_cast<const T*>(x);
  const G* gp = static_cast<const G*>(g);
  T* op = static_cast<T*>(out);
  switch (per) {
    case 1: rms_norm_kernel<T, G, A, VEC, 1><<<grid, block, 0, s>>>(
        xp, ld, gp, op, d, e, inv_d); break;
    case 2: rms_norm_kernel<T, G, A, VEC, 2><<<grid, block, 0, s>>>(
        xp, ld, gp, op, d, e, inv_d); break;
    case 4: rms_norm_kernel<T, G, A, VEC, 4><<<grid, block, 0, s>>>(
        xp, ld, gp, op, d, e, inv_d); break;
    case 8: rms_norm_kernel<T, G, A, VEC, 8><<<grid, block, 0, s>>>(
        xp, ld, gp, op, d, e, inv_d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename G, typename A>
int launch(const void* x, long long rows, long long ld, const void* g,
           void* out, int d, double eps, int vec, int per, int threads,
           cudaStream_t s) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if (vec == kVec)
    return launch_vec<T, G, A, kVec>(x, rows, ld, g, out, d, eps, per,
                                     threads, s);
  if (vec == 1)
    return launch_vec<T, G, A, 1>(x, rows, ld, g, out, d, eps, per, threads,
                                  s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the norm of `rows` rows of width d on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a plan
// it has no kernel for. Row i of x starts at x + i * ld elements; out is
// contiguous (rows, d). dtype: 0 bf16, 1 fp16, 2 float32, 3 float64 (x
// and out); gamma_wide: gamma is in float32 (a 2-byte x) rather than in
// x's type. vec (16 / element size, or 1), per and threads come from the
// wrapper's plan, which also checks alignment for vec > 1, 1 <= d,
// rows < 2^31 and threads a multiple of 32 up to 1024 covering the row.
extern "C" int rms_norm_launch(const void* x, long long rows, long long ld,
                               const void* gamma, void* out, int d,
                               int dtype, int gamma_wide, int vec, int per,
                               int threads, double eps, void* stream) {
  if (rows <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (long long)threads * per * vec < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (gamma_wide ? 1 : 0)) {
    case 0: return launch<__nv_bfloat16, __nv_bfloat16, float>(
        x, rows, ld, gamma, out, d, eps, vec, per, threads, s);
    case 1: return launch<__nv_bfloat16, float, float>(
        x, rows, ld, gamma, out, d, eps, vec, per, threads, s);
    case 2: return launch<__half, __half, float>(
        x, rows, ld, gamma, out, d, eps, vec, per, threads, s);
    case 3: return launch<__half, float, float>(
        x, rows, ld, gamma, out, d, eps, vec, per, threads, s);
    case 4: return launch<float, float, float>(
        x, rows, ld, gamma, out, d, eps, vec, per, threads, s);
    case 6: return launch<double, double, double>(
        x, rows, ld, gamma, out, d, eps, vec, per, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
