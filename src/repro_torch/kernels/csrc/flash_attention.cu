// Causal or full attention with grouped KV heads for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body `_kernel`):
// q (B,H,S,D), k and v (B,KV,S,D), query head h reading KV head h / G
// (G = H / KV), an online softmax with float32 running max, sum and
// accumulator, scores scaled by D^-0.5 and masked with -1e30, and the
// probabilities rounded to v's type before the PV product.
//
// Bound on an H100: at the LM slice's shape (B=8, H=25, KV=5, S=1024,
// D=64, bf16, causal) the work is ~26.8 GFLOP against ~63 MB of q, k, v
// and o, i.e. ~425 FLOP per byte, above the card's ~295 bf16 FLOP per
// byte: tensor-core operations bound it. The design is the plain
// FlashAttention-2 schedule on mma.sync:
//  - one block of 4 warps per (batch, head, 64-query tile); each warp
//    owns 16 query rows, holds its Q fragments in registers for the whole
//    pass and keeps S = QK^T, the running max/sum and the O accumulator in
//    registers (m16n8k16 bf16 products, float32 accumulators);
//  - K and V tiles of 64 keys are staged in shared memory with 8 elements
//    of row padding, so the 32-bit fragment loads of K and the ldmatrix
//    .trans loads of V are free of bank conflicts;
//  - under `causal`, key tiles wholly above the diagonal are skipped, not
//    masked (the TPU grid is rectangular and could only mask them), and
//    the query tiles are issued heaviest first;
//  - GQA reads KV head h / G in place; K and V are never expanded to H;
//  - any S: the ragged last tile is zero-filled in shared memory and its
//    keys masked, its query rows not stored (the TPU kernel asserted
//    S % 128 == 0);
//  - q, k, v and o are addressed through (batch, head, sequence) strides
//    with a unit last stride, so the model's (B,S,H,D) tensors are read
//    and written in place with no transpose copy.
// float32 inputs take a plain SIMT path (one thread per query row, exact
// float32 products), which serves the float32 model and the checks.
// wgmma, TMA and a pipelined K/V ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per staged tile
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;               // in elements; the last stride is 1
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, S, causal;
  float scale;                     // D^-0.5
  Strides qs, ks, vs, os;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// lo in the low half: the element with the smaller column index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + kRows) of one (batch, head) slice into a shared tile
// with leading dimension kLd, 16 bytes per thread and step; rows at or
// past S are zero-filled.
template <typename T, int D, int kLd, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(T* tile, const T* base,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = __ldg(reinterpret_cast<const uint4*>(
          base + (long long)(row0 + r) * row_stride + c * kVec));
    *reinterpret_cast<uint4*>(tile + r * kLd + c * kVec) = val;
  }
}

__device__ __forceinline__ int query_tile(const Params& p) {
  const int nq = (p.S + kBQ - 1) / kBQ;
  return p.causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
}

__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  const int n = (p.S + kBK - 1) / kBK;
  return p.causal ? min(n, (q0 + kBQ - 1) / kBK + 1) : n;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128) flash_bf16_kernel(const Params p) {
  constexpr int kLd = D + 8;       // padded row: conflict-free fragments
  constexpr int kKC = D / 16;      // k-chunks of QK^T over the head dim
  constexpr int kNT = D / 8;       // n-tiles of PV over the head dim
  constexpr int kST = kBK / 8;     // n-tiles of QK^T over a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * kLd;
  __nv_bfloat16* sV = sK + kBK * kLd;

  const int q0 = query_tile(p) * kBQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const auto* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.qs.b +
                   h * p.qs.h;
  const auto* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.ks.b +
                   kvh * p.ks.h;
  const auto* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.vs.b +
                   kvh * p.vs.h;

  load_tile<__nv_bfloat16, D, kLd, kBQ, 128>(sQ, qb, p.qs.s, q0, p.S);
  __syncthreads();
  const int r0 = warp * 16 + g;    // this thread's rows: r0 and r0 + 8
  uint32_t qf[kKC][4];
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
    qf[kc][0] = ld_u32(sQ + r0 * kLd + kc * 16 + t * 2);
    qf[kc][1] = ld_u32(sQ + (r0 + 8) * kLd + kc * 16 + t * 2);
    qf[kc][2] = ld_u32(sQ + r0 * kLd + kc * 16 + 8 + t * 2);
    qf[kc][3] = ld_u32(sQ + (r0 + 8) * kLd + kc * 16 + 8 + t * 2);
  }

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the sum
  const float sc = p.scale * kLog2e;
  const int qrow0 = q0 + r0, qrow1 = qrow0 + 8;
  const int n_kt = key_tiles(p, q0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();               // the previous tile's readers are done
    load_tile<__nv_bfloat16, D, kLd, kBK, 128>(sK, kb, p.ks.s, k0, p.S);
    load_tile<__nv_bfloat16, D, kLd, kBK, 128>(sV, vb, p.vs.s, k0, p.S);
    __syncthreads();

    float s[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * kLd + kc * 16 + t * 2;
        mma_bf16(s[j], qf[kc], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    const bool edge = (k0 + kBK > p.S) || (p.causal && k0 + kBK - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = s[j][e] * sc, v1 = s[j][2 + e] * sc;
        if (edge) {
          const int key = k0 + j * 8 + t * 2 + e;
          if (key >= p.S || (p.causal && key > qrow0)) v0 = kNegInf;
          if (key >= p.S || (p.causal && key > qrow1)) v1 = kNegInf;
        }
        s[j][e] = v0;
        s[j][2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - mn0);
        s[j][2 + e] = exp2f(s[j][2 + e] - mn1);
        ls0 += s[j][e];
        ls1 += s[j][2 + e];
      }
    }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V: P's accumulator layout is the A-fragment layout of the
    // next product, rounded to bf16 as the reference rounds p to v's type
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mi = lane >> 3, ri = lane & 7;
      const __nv_bfloat16* vrow =
          sV + (kk * 16 + ri + ((mi & 1) << 3)) * kLd + ((mi >> 1) << 3);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + n * 8);
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  auto* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (qrow0 < p.S)
      *reinterpret_cast<uint32_t*>(ob + qrow0 * p.os.s + n * 8 + t * 2) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (qrow1 < p.S)
      *reinterpret_cast<uint32_t*>(ob + qrow1 * p.os.s + n * 8 + t * 2) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// float32: one thread per query row, exact float32 products
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBQ) flash_f32_kernel(const Params p) {
  constexpr int kChunk = 16;       // keys per online-softmax update
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kBK * D;

  const int q0 = query_tile(p) * kBQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KV);
  const int row = q0 + threadIdx.x;
  const float* kb = static_cast<const float*>(p.k) + b * p.ks.b +
                    kvh * p.ks.h;
  const float* vb = static_cast<const float*>(p.v) + b * p.vs.b +
                    kvh * p.vs.h;

  float q[D], acc[D];
  const float* qr = static_cast<const float*>(p.q) + b * p.qs.b +
                    h * p.qs.h + (long long)min(row, p.S - 1) * p.qs.s;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = __ldg(qr + d);
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int n_kt = key_tiles(p, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<float, D, D, kBK, kBQ>(sK, kb, p.ks.s, k0, p.S);
    load_tile<float, D, D, kBK, kBQ>(sV, vb, p.vs.s, k0, p.S);
    __syncthreads();
    for (int j0 = 0; j0 < kBK; j0 += kChunk) {
      float s[kChunk];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = sK + (j0 + jj) * D;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(q[d], kr[d], dot);
        const int key = k0 + j0 + jj;
        float v = dot * p.scale;
        if (key >= p.S || (p.causal && key > row)) v = kNegInf;
        s[jj] = v;
        mx = fmaxf(mx, v);
      }
      const float mn = fmaxf(m, mx);
      const float al = expf(m - mn);
      m = mn;
      l *= al;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= al;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float pj = expf(s[jj] - mn);
        const float* vr = sV + (j0 + jj) * D;
        l += pj;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vr[d], acc[d]);
      }
    }
  }
  if (row < p.S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h +
                  (long long)row * p.os.s;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
  }
}

template <int D>
int launch(const Params& p, int is_bf16, cudaStream_t stream) {
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.B * p.H);
  if (is_bf16) {
    const int smem = (kBQ + 2 * kBK) * (D + 8) * (int)sizeof(__nv_bfloat16);
    cudaFuncSetAttribute(flash_bf16_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_bf16_kernel<D><<<grid, 128, smem, stream>>>(p);
  } else {
    const int smem = 2 * kBK * D * (int)sizeof(float);
    cudaFuncSetAttribute(flash_f32_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_f32_kernel<D><<<grid, kBQ, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches attention on `stream`; returns cudaGetLastError() (0 =
// launched). Strides are in elements, in (batch, head, sequence) order.
// The caller validates: one dtype (bf16 if is_bf16, else float32), unit
// last strides, 16-byte aligned rows, H % KV == 0, B*H <= 65535, S >= 1
// and D in {16, 32, 64, 128}.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int is_bf16, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.causal = causal;
  p.scale = 1.0f / sqrtf((float)D);
  p.qs = {q_sb, q_sh, q_ss};
  p.ks = {k_sb, k_sh, k_ss};
  p.vs = {v_sb, v_sh, v_ss};
  p.os = {o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, is_bf16, s);
    case 32: return launch<32>(p, is_bf16, s);
    case 64: return launch<64>(p, is_bf16, s);
    case 128: return launch<128>(p, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
