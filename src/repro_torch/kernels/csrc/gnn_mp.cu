// Fused batched-dense GNN message passing for Hopper (sm_90a), on the TF32
// tensor cores in full fp32 accuracy (3xTF32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gnn_mp.py::gnn_mp
// (body `_kernel`): one GNN layer out = relu(A @ (H @ Wn) + H @ Ws + b) over
// a batch of small dense graphs, A (B,N,N) or one (N,N) shared by every
// graph (batch stride 0), H (B,N,F), Ws/Wn (F,Fo), b (Fo,), all fp32.
//
// Bound on an H100: operations. One engine chunk (B=512, N=32, F=Fo=300)
// is 6.21 GFLOP a layer (5.90 in the two products over F, 0.31 in the
// aggregation) against ~42 MB of activations (0.0125 ms at 3.35 TB/s).
// On the fp32 SIMT units (67 TFLOP/s) that is 0.093 ms; on the TF32 tensor
// cores (495 TFLOP/s), with every product issued three times (below),
// 0.0376 ms. The design puts all of it on the tensor cores:
//   * arithmetic: mma.sync m16n8k8 TF32 with fp32 accumulators. Each
//     operand x is split in registers into hi = tf32_rna(x) and
//     lo = tf32_rna(x - hi) (rounded to nearest as cvt.rna.tf32.f32
//     rounds, in two integer operations), and a*b is lo_a*hi_b + hi_a*lo_b +
//     hi_a*hi_b (the lo*lo term is ~2^-22 of the product); the small terms
//     are summed in accumulators of their own and added last. TF32
//     products are exact in fp32, so the result keeps fp32's accuracy and
//     the fp32 plain version's 1e-4 bar, which one TF32 product misses at
//     F = 300 (tests/test_torch_kernels.py emulates both on the CPU);
//   * tiles: a block owns the rows of whole graphs (64 rows: floor(64/N)
//     graphs) and 64 output columns; its 4 warps, 2 x 2, each hold a
//     32 x 32 tile (2 m16 x 4 n8 fragments) of BOTH products (H@Ws,
//     H@Wn), so the H fragment is split once and feeds both. 128 columns
//     or rows a block (8 warps), or 8 warps of 16 x 32, measured slower;
//   * staging: H and the two weight panels stream in K-steps of 32 through
//     a 3-stage cp.async ring (16-byte cp.async.cg where a row is 16-byte
//     aligned, 4-byte cp.async.ca otherwise: the first layer's F = 27 rows
//     are 108 bytes); ragged rows, columns and K are zero-filled through
//     the source-size operand. Shared rows are padded (H +8, W +4 floats)
//     so that every fragment load is free of bank conflicts; weights are
//     read row-major (K, N) as they lie, with no transposed copy;
//   * epilogue: the H@Wn tile goes to shared memory (in place of the ring)
//     and is aggregated on the tensor cores too (3xTF32): the block's
//     adjacency, staged once as a block-diagonal 64x64 tile (zero between
//     graphs), times the tile, added into the H@Ws accumulators; a warp
//     runs only the k8 steps its rows' graphs touch. Bias, ReLU, store.
// What bounds this design on the card is the HMMAs themselves: mma.sync
// issues TF32 at about half the tensor cores' peak, and 3xTF32 issues
// three; then the rounding and the staging copies' issue cost (the ring's
// waits cost nothing). scripts/kernel_variants.py gnn_mp measures each.
// wgmma (the full rate; TF32 takes B K-major, so the weights would need a
// transposed copy), TMA and a persistent grid are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;      // graph nodes (rows) per block
constexpr int kCols = 64;      // output columns per block
constexpr int kWarpsM = 2;     // warps along the rows
constexpr int kWarpsN = 2;     // warps along the columns
constexpr int kStep = 32;      // K step per ring stage
constexpr int kStages = 3;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMaxN = 64;
constexpr int kWarpRows = kRows / kWarpsM;
constexpr int kMT = kWarpRows / 16;            // m16 fragments a warp
constexpr int kNT = kCols / kWarpsN / 8;       // n8 fragments a warp
// The k8 step's columns are taken in the order 0, 2, 4, 6, 1, 3, 5, 7
// (A's and B's alike, so the product is the same): a thread's two A
// values of a row, k = 2t and 2t + 1, are then neighbours, read by one
// 64-bit load. Padded rows in floats: A rows g = 0..7 at a stride of
// 8 mod 32 banks, B rows 2t at a stride of 4 mod 32, columns g, make
// every fragment load conflict-free.
constexpr int kHStride = kStep + 8;
constexpr int kWStride = kCols + 4;
constexpr int kAdjStride = kRows + 8;
constexpr int kHTile = kRows * kHStride;
constexpr int kWTile = kStep * kWStride;
constexpr int kStageFloats = kHTile + 2 * kWTile;
constexpr int kRingFloats = kStages * kStageFloats;
constexpr int kSmemBytes = 4 * (kRingFloats + kRows * kAdjStride);
static_assert(kRows % (16 * kWarpsM) == 0 && kCols % (8 * kWarpsN) == 0,
              "warp tiles of whole fragments");
static_assert(kRows * kWStride <= kRingFloats, "the H@Wn tile fits the ring");
static_assert(kThreads % kRows == 0 && (kRows * kStep / 4) % kThreads == 0 &&
                  (kStep * kCols / 4) % kThreads == 0,
              "every thread stages the same number of elements");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 (4) bytes when `ok`, else zero-fills them; `src` must be a
// valid address either way.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to nearest,
// ties away from zero (add half of the 13 dropped bits, then drop them).
// Two integer operations: cvt's guard for inf and NaN costs three more a
// value on sm_90, and a non-finite x still gives a non-finite result here
// (through x - hi).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value rounded to nearest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragments (rows r0 + 16 i .., columns k .. in the order above) of a
// row-major tile.
template <int kStride>
__device__ __forceinline__ void load_a(const float* t, int r0, int k, int g,
                                       int tq, uint32_t (&hi)[kMT][4],
                                       uint32_t (&lo)[kMT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const float* p = t + (r0 + 16 * i + g) * kStride + k + 2 * tq;
    const float2 top = *reinterpret_cast<const float2*>(p);
    const float2 bot = *reinterpret_cast<const float2*>(p + 8 * kStride);
    split(top.x, hi[i][0], lo[i][0]);
    split(bot.x, hi[i][1], lo[i][1]);
    split(top.y, hi[i][2], lo[i][2]);
    split(bot.y, hi[i][3], lo[i][3]);
  }
}

// big += hi_A hi_B and small += lo_A hi_B + hi_A lo_B over a k8 step of A
// and the (K, N) row-major tile t (rows k.., columns c0 + 8 j ..). The
// small terms keep their own accumulator: an mma rounds its sum toward
// zero at the accumulator's magnitude, so folding them into the large
// sum would add two such roundings a step. Every fragment runs, also past
// Fo: skipping those (a warp-uniform branch a fragment) measured slower.
template <int kStride>
__device__ __forceinline__ void mma3(float (&big)[kMT][kNT][4],
                                     float (&small)[kMT][kNT][4],
                                     const uint32_t (&ah)[kMT][4],
                                     const uint32_t (&al)[kMT][4],
                                     const float* t, int k, int c0, int g,
                                     int tq) {
  uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float* p = t + (k + 2 * tq) * kStride + c0 + 8 * j + g;
    split(p[0], bh[j][0], bl[j][0]);
    split(p[kStride], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      mma_tf32(small[i][j], al[i], bh[j]);
      mma_tf32(big[i][j], ah[i], bh[j]);
    }
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(small[i][j], ah[i], bl[j]);
}

// One thread's share of a ring stage: H rows [row0, row0 + rows) x K
// [k0, k0 + kStep), and both weight panels K [k0, k0 + kStep) x columns
// [c0, c0 + kCols), in copies of 16 bytes (F, Fo % 4 == 0: a copy is all
// in or all out) or 4. A thread's column in each tile is fixed and its
// rows step by a fixed count, so the addresses are set up once a block
// and a stage only adds its K offset.
template <bool kH16, bool kW16>
struct Stager {
  static constexpr int kHv = kH16 ? 4 : 1;                    // floats a copy
  static constexpr int kHRowStep = kThreads / (kStep / kHv);  // rows apart
  static constexpr int kHCopies = kRows / kHRowStep;
  static constexpr int kWv = kW16 ? 4 : 1;
  static constexpr int kWRowStep = kThreads / (kCols / kWv);
  static constexpr int kWCopies = kStep / kWRowStep;
  static_assert(kHCopies <= 32, "one bit a copy");

  const float* h_row;    // the thread's first H row, at its column
  long long h_step;      // kHRowStep rows of H
  long long w_off;       // the thread's first weight element at K = 0
  int h_col, h_dst, w_row, w_dst, F, Fo;
  unsigned h_rows;       // bit j: the thread's j-th H row is < rows
  bool w_col;            // the thread's weight columns are < Fo

  __device__ __forceinline__ Stager(const float* h, long long row0, int rows,
                                    int F_, int Fo_, int c0, int tid)
      : F(F_), Fo(Fo_) {
    h_col = (tid % (kStep / kHv)) * kHv;
    const int hr = tid / (kStep / kHv);
    h_row = h + (row0 + hr) * F + h_col;
    h_step = (long long)kHRowStep * F;
    h_dst = hr * kHStride + h_col;
    h_rows = 0;
#pragma unroll
    for (int j = 0; j < kHCopies; ++j)
      if (hr + j * kHRowStep < rows) h_rows |= 1u << j;
    const int wc = (tid % (kCols / kWv)) * kWv;
    w_row = tid / (kCols / kWv);
    w_col = c0 + wc < Fo;
    w_off = (long long)w_row * Fo + c0 + wc;
    w_dst = w_row * kWStride + wc;
  }

  __device__ __forceinline__ void copy(float* dst, const float* src,
                                       bool ok, bool wide) const {
    if (wide)
      cp_async16(dst, src, ok);
    else
      cp_async4(dst, src, ok);
  }

  __device__ __forceinline__ void load(float* st, const float* h,
                                       const float* ws, const float* wn,
                                       int k0) const {
    float* sh = st + h_dst;
    const bool h_k = k0 + h_col < F;
#pragma unroll
    for (int j = 0; j < kHCopies; ++j) {
      const bool ok = h_k && (h_rows >> j & 1u);
      copy(sh + j * kHRowStep * kHStride, ok ? h_row + j * h_step + k0 : h,
           ok, kH16);
    }
    float* sws = st + kHTile + w_dst;
    const long long w_k0 = w_off + (long long)k0 * Fo;
#pragma unroll
    for (int j = 0; j < kWCopies; ++j) {
      const bool ok = w_col && k0 + w_row + j * kWRowStep < F;
      const long long off = ok ? w_k0 + (long long)(j * kWRowStep) * Fo : 0;
      copy(sws + j * kWRowStep * kWStride, ws + off, ok, kW16);
      copy(sws + kWTile + j * kWRowStep * kWStride, wn + off, ok, kW16);
    }
  }
};

template <bool kH16, bool kW16>
__global__ void __launch_bounds__(kThreads)
gnn_mp_kernel(const float* __restrict__ adj, long long adj_batch_stride,
              const float* __restrict__ h, const float* __restrict__ w_self,
              const float* __restrict__ w_nbr, const float* __restrict__ bias,
              float* __restrict__ out, int B, int N, int F, int Fo,
              int graphs_per_block) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* sadj = smem + kRingFloats;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const int wr = (warp / kWarpsN) * kWarpRows;
  const int wc = (warp % kWarpsN) * (kCols / kWarpsN);
  const int g0 = blockIdx.y * graphs_per_block;
  const int G = min(graphs_per_block, B - g0);
  const int rows = G * N;                        // valid rows of this block
  const long long row0 = (long long)g0 * N;      // its first global row
  const int c0 = blockIdx.x * kCols;
  const int KT = (F + kStep - 1) / kStep;
  const bool busy = wr < rows;     // a warp with no valid rows: no products

  // The block's adjacency as one block-diagonal (64, 64) tile, zero
  // between graphs and past `rows`; its copies join the first stage's
  // group. The graph of a row, r / N, as (r + 0.5) * (1 / N): r < 64 lies
  // at least 0.5 / N from a multiple of N, far beyond the rounding.
  {
    const float inv_n = 1.f / N;
    const int q = tid % kRows;
    const int qg = __float2int_rz((q + 0.5f) * inv_n);
    for (int r = tid / kRows; r < kRows; r += kThreads / kRows) {
      const int rg = __float2int_rz((r + 0.5f) * inv_n);
      float* dst = sadj + r * kAdjStride + q;
      if (r < rows && q < rows && rg == qg)
        cp_async4(dst,
                  adj + (long long)(g0 + rg) * adj_batch_stride +
                      (r - rg * N) * N + (q - qg * N),
                  true);
      else
        *dst = 0.f;
    }
  }
  const Stager<kH16, kW16> stager(h, row0, rows, F, Fo, c0, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT)
      stager.load(ring + s * kStageFloats, h, w_self, w_nbr, s * kStep);
    cp_async_commit();
  }

  // H@Ws and H@Wn, each as its hi*hi sum and its sum of small terms
  float own[kMT][kNT][4], own_lo[kMT][kNT][4];
  float nbr[kMT][kNT][4], nbr_lo[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        own[i][j][e] = own_lo[i][j][e] = nbr[i][j][e] = nbr_lo[i][j][e] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();   // stage kt has landed (this thread's)
    __syncthreads();                // ... everyone's; stage kt-1 is free
    const int next = kt + kStages - 1;
    if (next < KT)
      stager.load(ring + (next % kStages) * kStageFloats, h, w_self, w_nbr,
                  next * kStep);
    cp_async_commit();
    const float* sh = ring + (kt % kStages) * kStageFloats;
    const float* sws = sh + kHTile;
    const float* swn = sws + kWTile;
    const int k_valid = F - kt * kStep;   // k8 steps past it are all zero
#pragma unroll
    for (int ks = 0; ks < kStep / 8; ++ks) {
      if (8 * ks < k_valid && busy) {
        uint32_t ah[kMT][4], al[kMT][4];
        load_a<kHStride>(sh, wr, 8 * ks, g, tq, ah, al);
        mma3<kWStride>(own, own_lo, ah, al, sws, 8 * ks, wc, g, tq);
        mma3<kWStride>(nbr, nbr_lo, ah, al, swn, 8 * ks, wc, g, tq);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // every warp is done with the ring

  // the H@Wn tile, row-major (64, kCols), in place of the ring
  float* msg = ring;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr + 16 * i + g + 8 * half;
        const int c = wc + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(msg + r * kWStride + c) =
            make_float2(nbr[i][j][2 * half] + nbr_lo[i][j][2 * half],
                        nbr[i][j][2 * half + 1] + nbr_lo[i][j][2 * half + 1]);
      }
  __syncthreads();

  // own += adjacency @ msg over the columns of the graphs of this warp's
  // rows (the rest of the tile's row is zero)
  if (busy) {
    const int last = min(wr + kWarpRows, rows) - 1;
    const int q_begin = (wr / N) * N / 8 * 8;
    const int q_end = min(rows, (last / N + 1) * N);
    for (int q = q_begin; q < q_end; q += 8) {
      uint32_t ah[kMT][4], al[kMT][4];
      load_a<kAdjStride>(sadj, wr, q, g, tq, ah, al);
      mma3<kWStride>(own, own_lo, ah, al, msg, q, wc, g, tq);
    }
  }

  const bool pairs = Fo % 2 == 0;   // float2 stores stay 8-byte aligned
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wr + 16 * i + g + 8 * half;
      if (r >= rows) continue;
      float* orow = out + (row0 + r) * Fo;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = c0 + wc + 8 * j + 2 * tq;
        if (col >= Fo) continue;
        const float s0 = own[i][j][2 * half] + own_lo[i][j][2 * half];
        const float s1 = own[i][j][2 * half + 1] + own_lo[i][j][2 * half + 1];
        const float v0 = fmaxf(s0 + bias[col], 0.f);
        if (pairs) {
          const float v1 = fmaxf(s1 + bias[col + 1], 0.f);
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          orow[col] = v0;
          if (col + 1 < Fo) orow[col + 1] = fmaxf(s1 + bias[col + 1], 0.f);
        }
      }
    }
}

template <bool kH16, bool kW16>
int launch(const float* adj, long long adj_batch_stride, const float* h,
           const float* w_self, const float* w_nbr, const float* bias,
           float* out, int B, int N, int F, int Fo, cudaStream_t stream) {
  const int graphs_per_block = kRows / N;
  const dim3 grid((Fo + kCols - 1) / kCols,
                  (B + graphs_per_block - 1) / graphs_per_block);
  cudaFuncSetAttribute(gnn_mp_kernel<kH16, kW16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  gnn_mp_kernel<kH16, kW16><<<grid, kThreads, kSmemBytes, stream>>>(
      adj, adj_batch_stride, h, w_self, w_nbr, bias, out, B, N, F, Fo,
      graphs_per_block);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches one layer on `stream`; returns cudaGetLastError() (0 = launched).
// The caller validates shapes: 1 <= N <= 64, contiguous fp32 tensors. Rows
// of H (of the weights) are staged by 16-byte copies where F (Fo) is a
// multiple of 4 and the tensor starts 16-byte aligned, else by 4-byte ones.
extern "C" int gnn_mp_launch(const float* adj, long long adj_batch_stride,
                             const float* h, const float* w_self,
                             const float* w_nbr, const float* bias,
                             float* out, int B, int N, int F, int Fo,
                             void* stream) {
  if (B <= 0 || Fo <= 0) return 0;
  if (N < 1 || N > kMaxN || F < 0) return (int)cudaErrorInvalidValue;
  const bool h16 = F % 4 == 0 && aligned16(h);
  const bool w16 = Fo % 4 == 0 && aligned16(w_self) && aligned16(w_nbr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h16 && w16)
    return launch<true, true>(adj, adj_batch_stride, h, w_self, w_nbr, bias,
                              out, B, N, F, Fo, s);
  if (h16)
    return launch<true, false>(adj, adj_batch_stride, h, w_self, w_nbr, bias,
                               out, B, N, F, Fo, s);
  if (w16)
    return launch<false, true>(adj, adj_batch_stride, h, w_self, w_nbr, bias,
                               out, B, N, F, Fo, s);
  return launch<false, false>(adj, adj_batch_stride, h, w_self, w_nbr, bias,
                              out, B, N, F, Fo, s);
}
