// Causal or full attention with grouped KV heads for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body `_kernel`):
// q (B,H,Sq,D), k and v (B,KV,Sk,D), query head h reading KV head h / G
// (G = H / KV), an online softmax with float32 running max, sum and
// accumulator, scores scaled by D^-0.5 and masked with -1e30, and the
// probabilities rounded to v's type before the PV product. The TPU kernel
// takes Sq == Sk; this one also takes Sq < Sk, the causal mask aligned
// bottom-right: query row i sits at key position Sk - Sq + i (a block of
// a sequence's queries over the keys up to the block's end, as a context-
// parallel shard holds them; cross-attention under a full mask). With
// Sq == Sk every index below is the TPU kernel's.
//
// Bound on an H100: at the LM slice's shape (B=8, H=25, KV=5, S=1024,
// D=64, bf16, causal) the work is 26.87 GFLOP against ~63 MB of q, k, v
// and o, ~425 FLOP per byte, above the card's ~295 bf16 FLOP per byte:
// tensor-core operations bound it (0.027 ms at 989 TFLOP/s). The exp2 of
// the softmax (16 a clock on an SM) costs as much time as the two
// products at D=64, so the products have to run while the softmax does.
//
// bf16, one kernel for every head dim (16, 32, 64, 128), warp-specialised
// and persistent (one block an SM walks the work items):
//  - a work item is 64 x kWG query rows of one (batch, head): kWG = 3
//    consumer warpgroups of 64 rows for D <= 64, 2 for D = 128 (whose O
//    accumulator needs the registers); one thread of a producer
//    warpgroup, its registers given to the consumers with setmaxnreg,
//    issues every TMA load;
//  - Q is loaded by TMA into one of two buffers (one at D = 128), while
//    the item before it is still computed; K and V tiles of 128 keys
//    stream through a 3-stage ring in shared memory with full/empty
//    mbarriers, so the next tiles are in flight while the tensor cores
//    work, each tile read once for the item's rows; at D = 128 K and V
//    land on barriers of their own;
//  - S = Q K^T is wgmma m64n128k16 with both operands in shared memory (K
//    stored key-major, D contiguous: already K-major); O += P V is wgmma
//    m64nDk16 with P from registers (the S accumulator rounded to bf16:
//    for 16-bit types the accumulator's fragment is the A operand's) and
//    V from shared memory in the transposed (MN-major) form. A warpgroup
//    issues S_j and the PV product of tile j-1 together and computes the
//    softmax of S_j while the latter runs; with two warpgroups, named
//    barriers pass the turn at the tensor cores between them, so one's
//    softmax overlaps the other's products;
//  - TMA writes the tiles swizzled (128 B for D >= 64, D = 128 as two
//    64-column boxes; 64 B for D = 32; 32 B for D = 16), and every wgmma
//    descriptor names the same mode, so the tensor cores read without
//    bank conflicts;
//  - the tensor maps are 4-D, (D, S, heads, B), over the strided views,
//    so the model's (B,S,H,D) tensors are read in place; S is a bounded
//    dimension, so the ragged last tile is zero-filled by the hardware
//    and never reads the next sequence; its keys are masked and its query
//    rows not stored;
//  - under `causal`, key tiles wholly above a warpgroup's rows are
//    skipped, and the heaviest query tiles are dealt first, in rounds
//    that alternate direction across the blocks;
//  - GQA reads KV head h / G in place; K and V are never expanded to H.
// float32 inputs take a plain SIMT path (one thread per query row, exact
// float32 products), which serves the float32 model and the checks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

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
  int B, H, KV, Sq, Sk, causal;   // Sq <= Sk
  float scale;                     // D^-0.5
  Strides qs, ks, vs, os;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

// The launch plan of the bf16 kernel; kernels/flash_attention.py::plan
// computes the same numbers and the launcher checks them.
template <int D>
struct Plan {
  // consumer warpgroups of 64 query rows: three where their registers
  // fit (S, P and O of D <= 64 in 160 a thread), two for D = 128
  static constexpr int kWG = D == 128 ? 2 : 3;
  static constexpr int kBQ = 64 * kWG;             // query rows per item
  static constexpr int kBK = 128;                  // keys per ring stage
  static constexpr int kStages = 3;
  // Q of two work items, or of one where the ring needs the room
  static constexpr int kQBufs = D == 128 ? 1 : 2;
  // K and V on barriers of their own: measured a gain at D = 128, a loss
  // below (where the ring's loads are hidden anyway)
  static constexpr bool kSplitKV = D == 128;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;  // and the producer's
  // turns at the tensor cores pass round the consumers in a ring: a
  // measured gain with two warpgroups, a loss with three
  static constexpr bool kPingPong = kWG == 2;
  // setmaxnreg: the producer gives its registers to the consumers
  static constexpr int kRegsProducer = kWG == 3 ? 24 : 40;
  static constexpr int kRegsConsumer = kWG == 3 ? 160 : 232;
  // setmaxnreg moves registers within what the block got at launch:
  // 65536 / kThreads a thread, rounded down to a multiple of 8
  static_assert(128 * kRegsProducer + kConsumers * kRegsConsumer <=
                    kThreads * (65536 / kThreads / 8 * 8),
                "the block's registers");
  static constexpr int kBoxD = D < 64 ? D : 64;    // columns of a TMA box
  static constexpr int kBoxes = D / kBoxD;
  static constexpr int kRowBytes = kBoxD * 2;      // = the swizzle span
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;   // one K or V tile
  // Q full/empty per buffer; K full, V full and empty per stage
  static constexpr int kBarBytes = 8 * (2 * kQBufs + 3 * kStages);
  static constexpr int kSmem =
      1024 + kQBufs * kQBytes + 2 * kStages * kTileBytes + kBarBytes;
  // wgmma descriptor layout: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static_assert(kSmem <= 232448, "shared memory of one block");
  static_assert(D % 16 == 0 && D <= 256, "wgmma N and K steps");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase with parity `parity` has completed. A
// wait that never ends (a fault in the pipeline) traps after 2^24 polls,
// so it fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) asm volatile("trap;");
  }
}

// One box of a 4-D tensor map into shared memory; completion is counted
// in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
template <uint64_t kLayout>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// lo in the low half: the element with the smaller column index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, float32) (+)= A (64 x 16, shared) * B (128 x 16, shared)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 16, float32) += A (64 x 16, registers) * B (16 x 16, shared,
// 16 contiguous: the transposed form)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, float32) += A (64 x 16, registers) * B (16 x 32, shared,
// 32 contiguous: the transposed form)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, shared,
// 64 contiguous: the transposed form)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, registers) * B (16 x 128, shared,
// 128 contiguous: the transposed form)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

struct Shape {
  int B, H, KV, Sq, Sk, causal;    // query row i sits at key Sk - Sq + i
  float scale;                     // D^-0.5
  __nv_bfloat16* o;
  Strides os;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x kBK) = Q (this warpgroup's 64 rows) K^T over the head dim, 16
// columns a step; Q and K are K-major, kBoxD columns a swizzled box.
template <int D>
__device__ __forceinline__ void qk_issue(float (&s)[Plan<D>::kBK / 2],
                                         uint32_t sQw, uint32_t sK) {
  using P = Plan<D>;
  constexpr int kSteps = P::kBoxD / 16;      // k-steps per box
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / kSteps) * P::kBK * P::kRowBytes +
                         (kk % kSteps) * 32;
    const uint64_t da = smem_desc<P::kLayout>(sQw + off, 16, 8 * P::kRowBytes);
    const uint64_t db = smem_desc<P::kLayout>(sK + off, 16, 8 * P::kRowBytes);
    wgmma_ss_n128(s, da, db, kk > 0);
  }
}

// O (64 x D) += P (64 x kBK, registers) V (kBK x D), 16 keys a step; V is
// MN-major (D contiguous), its boxes kBK rows apart.
template <int D>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2],
                                         const uint32_t (&pa)[Plan<D>::kBK / 16][4],
                                         uint32_t sV) {
  using P = Plan<D>;
#pragma unroll
  for (int kk = 0; kk < P::kBK / 16; ++kk) {
    const uint64_t db = smem_desc<P::kLayout>(
        sV + kk * 16 * P::kRowBytes, P::kBK * P::kRowBytes,
        8 * P::kRowBytes);
    wgmma_rs<D>(o, pa[kk], db);
  }
}

// Online softmax of one score tile in place: s[4j + e] is row r0 (e < 2)
// or r0 + 8, key k0 + 8j + 2t + (e & 1); row r0 sits at key position d0.
// Masks keys past S and, under `causal`, past the row's position; moves the running max m (log2 units) and
// returns the factors al that rescale the earlier sum and accumulator,
// and this tile's share ls of the row sums.
template <int kBK>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], bool edge,
                                             int k0, int t, int d0, int S,
                                             int causal, float sc,
                                             float (&m)[2], float (&al)[2],
                                             float (&ls)[2]) {
  const float ninf = __int_as_float(0xff800000u);
  if (edge) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + t * 2 + e;
        if (key >= S || (causal && key > d0)) s[4 * j + e] = ninf;
        if (key >= S || (causal && key > d0 + 8)) s[4 * j + 2 + e] = ninf;
      }
    }
  }
  // max and sum in 4 independent chains per row: few warps share a
  // scheduler here, so the latency of one long chain would show
  constexpr int kC = 4;
  float mx[2][kC], sm[2][kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) mx[0][c] = mx[1][c] = ninf;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    mx[0][j % kC] = fmaxf(mx[0][j % kC], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1][j % kC] = fmaxf(mx[1][j % kC], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float row_max = fmaxf(fmaxf(mx[r][0], mx[r][1]),
                                fmaxf(mx[r][2], mx[r][3]));
    // a masked score counts as -1e30 in the max, as in the reference
    const float mn = fmaxf(m[r], quad_max(row_max) * sc);
    al[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) sm[0][c] = sm[1][c] = 0.f;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sc, -m[0]));
      s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], sc, -m[1]));
      sm[0][j % kC] += s[4 * j + e];
      sm[1][j % kC] += s[4 * j + 2 + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    ls[r] = (sm[r][0] + sm[r][1]) + (sm[r][2] + sm[r][3]);
}

// O's rows times the softmax's rescale factors
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&al)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= al[0];
    o[4 * j + 1] *= al[0];
    o[4 * j + 2] *= al[1];
    o[4 * j + 3] *= al[1];
  }
}

// Named barriers 1.. pass the consumer warpgroups' turns at the tensor
// cores round a ring (256 threads: one warpgroup syncs, the one before it
// arrives)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// P rounded to bf16, as the reference rounds p to v's type; the S
// accumulator's fragment is the A operand's for 16-bit types.
template <int kBK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBK / 16][4],
                                       const float (&s)[kBK / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Shape p) {
  using P = Plan<D>;
  constexpr int kBQ = P::kBQ, kBK = P::kBK, kStages = P::kStages;
  constexpr int kWG = P::kWG, kRow = P::kRowBytes;
  constexpr int kWarps = 4 * kWG;            // consumer warps
  extern __shared__ unsigned char smem_raw[];
  // every tile on a 1024-byte boundary: the 128 B swizzle's period
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + P::kQBufs * P::kQBytes;  // stage s: K, then V
  const uint32_t bar_q_full = sKV + 2 * kStages * P::kTileBytes;
  const uint32_t bar_q_empty = bar_q_full + 8 * P::kQBufs;
  const uint32_t bar_k_full = bar_q_empty + 8 * P::kQBufs;
  const uint32_t bar_v_full = bar_k_full + 8 * kStages;
  const uint32_t bar_empty = bar_v_full + 8 * kStages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < P::kQBufs; ++i) {
      mbar_init(bar_q_full + 8 * i, 1);
      mbar_init(bar_q_empty + 8 * i, kWarps);  // one arrive a consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k_full + 8 * s, 1);
      mbar_init(bar_v_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work items: (query tile, batch * head), the heaviest query tiles
  // first, dealt to the blocks (one an SM) in rounds of gridDim.x that
  // alternate in direction, so a block that drew a heavy item in one round
  // draws a light one in the next.
  const int BH = p.B * p.H;
  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int nk = (p.Sk + kBK - 1) / kBK;
  const int off = p.Sk - p.Sq;         // the key position of query row 0
  const int n_items = nq * BH;
  auto item_of = [&](int n) {          // this block's n-th item, or -1
    const int j = (n & 1) ? (int)(gridDim.x - 1 - blockIdx.x)
                          : (int)blockIdx.x;
    const long long w = (long long)n * gridDim.x + j;
    return w < n_items ? (int)w : -1;
  };
  // key tiles that rows [r, r_end) read: under `causal` up to the last
  // row's position; none for rows at or past Sq
  auto key_tiles = [&](int r, int r_end) {
    r_end = min(r_end, p.Sq);
    if (r >= r_end) return 0;
    return p.causal ? min(nk, (r_end - 1 + off) / kBK + 1) : nk;
  };
  struct Item {
    int q0, b, h, n_kt;
  };
  auto item = [&](int w) {
    Item it;
    const int qi = w / BH, bh = w % BH;
    it.q0 = (p.causal ? nq - 1 - qi : qi) * kBQ;
    it.b = bh / p.H;
    it.h = bh % p.H;
    it.n_kt = key_tiles(it.q0, it.q0 + kBQ);
    return it;
  };

  if (threadIdx.x >= P::kConsumers) {
    // ---- producer: one thread keeps Q and the K/V ring full ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P::kRegsProducer));
    if (threadIdx.x == P::kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int n = 0, w; (w = item_of(n)) >= 0; ++n) {
        const Item it = item(w);
        const int kvh = it.h / (p.H / p.KV);
        // Q into its buffer once the item that used it last released it
        const int qb = n % P::kQBufs;
        mbar_wait(bar_q_empty + 8 * qb, ((n / P::kQBufs) & 1) ^ 1);
        mbar_expect_tx(bar_q_full + 8 * qb, P::kQBytes);
#pragma unroll
        for (int x = 0; x < P::kBoxes; ++x)
          tma_load_4d(sQ + qb * P::kQBytes + x * kBQ * kRow, &tq,
                      bar_q_full + 8 * qb, x * P::kBoxD, it.q0, it.h, it.b);
        for (int kt = 0; kt < it.n_kt; ++kt) {
          mbar_wait(bar_empty + 8 * stage, phase ^ 1);
          const uint32_t k_full = bar_k_full + 8 * stage;
          const uint32_t v_full = bar_v_full + 8 * stage;
          const uint32_t sK = sKV + 2 * stage * P::kTileBytes;
          // with kSplitKV, K and V land on barriers of their own: S = Q K^T
          // need not wait for V
          mbar_expect_tx(k_full, (P::kSplitKV ? 1 : 2) * P::kTileBytes);
#pragma unroll
          for (int x = 0; x < P::kBoxes; ++x)
            tma_load_4d(sK + x * kBK * kRow, &tk, k_full, x * P::kBoxD,
                        kt * kBK, kvh, it.b);
          if (P::kSplitKV) mbar_expect_tx(v_full, P::kTileBytes);
#pragma unroll
          for (int x = 0; x < P::kBoxes; ++x)
            tma_load_4d(sK + P::kTileBytes + x * kBK * kRow, &tv,
                        P::kSplitKV ? v_full : k_full, x * P::kBoxD,
                        kt * kBK, kvh, it.b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroups of 64 query rows ----------------------------
    // Tile j's softmax runs while the tensor cores do tile j-1's PV
    // product (and the other warpgroups' products): S_j = Q K_j^T and
    // O = al O + P_{j-1} V_{j-1} are issued together, the first waited
    // for, the second only before P_j is written.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::kRegsConsumer));
    const int cw = threadIdx.x / 128;
    const int tid = threadIdx.x % 128, lane = tid & 31;
    const int t = lane & 3;
    const int row = cw * 64 + (tid >> 5) * 16 + (lane >> 2);  // and row + 8
    const float sc = p.scale * kLog2e;
    // ping-pong: the warpgroups take turns at the tensor cores in a ring,
    // the first warpgroup first
    if (P::kPingPong && cw == 0) bar_arrive(1);
    auto turn_begin = [&] {
      if (P::kPingPong) bar_sync(1 + cw);
    };
    auto turn_end = [&] {
      if (P::kPingPong) bar_arrive(1 + (cw + 1) % kWG);
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    int stage = 0;
    uint32_t phase = 0;
    auto advance = [&] {
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int n = 0, w; (w = item_of(n)) >= 0; ++n) {
      const Item it = item(w);
      const int qb = n % P::kQBufs;
      const uint32_t sQw = sQ + qb * P::kQBytes + cw * 64 * kRow;
      const int wrow = it.q0 + cw * 64;        // this warpgroup's first row
      const int r0 = it.q0 + row;
      const int n_kt = key_tiles(wrow, wrow + 64);  // this warpgroup's
      auto edge = [&](int k0) {                // a tile that needs the mask
        return (k0 + kBK > p.Sk) || (p.causal && k0 + kBK - 1 > wrow + off);
      };

      mbar_wait(bar_q_full + 8 * qb, (n / P::kQBufs) & 1);
      if (n_kt == 0) release(bar_q_empty + 8 * qb);
      if (n_kt > 0) {
        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m[2] = {kNegInf, kNegInf};   // running max, log2 units
        float l[2], s[kBK / 2], al[2];
        uint32_t pa[kBK / 16][4];

        // the first tile: S, its softmax, P
        mbar_wait(bar_k_full + 8 * stage, phase);
        turn_begin();
        fence_regs(s);
        wgmma_fence();
        qk_issue<D>(s, sQw, sKV + 2 * stage * P::kTileBytes);
        wgmma_commit();
        turn_end();
        wgmma_wait_all();
        fence_regs(s);
        if (n_kt == 1) release(bar_q_empty + 8 * qb);
        softmax_tile<kBK>(s, edge(0), 0, t, r0 + off, p.Sk, p.causal, sc, m,
                          al, l);
        pack_p<kBK>(pa, s);
        int prev = stage;                  // the stage the next PV reads
        uint32_t prev_phase = phase;
        advance();

        for (int kt = 1; kt < n_kt; ++kt) {
          const int k0 = kt * kBK;
          mbar_wait(bar_k_full + 8 * stage, phase);
          turn_begin();
          fence_regs(s);
          wgmma_fence();
          qk_issue<D>(s, sQw, sKV + 2 * stage * P::kTileBytes);
          wgmma_commit();
          rescale<D>(o, al);
          if (P::kSplitKV) mbar_wait(bar_v_full + 8 * prev, prev_phase);
          fence_regs(o);
          wgmma_fence();
          pv_issue<D>(o, pa, sKV + (2 * prev + 1) * P::kTileBytes);
          wgmma_commit();
          turn_end();
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          fence_regs(s);
          if (kt == n_kt - 1) release(bar_q_empty + 8 * qb);
          float ls[2];
          softmax_tile<kBK>(s, edge(k0), k0, t, r0 + off, p.Sk, p.causal, sc,
                            m, al, ls);
#pragma unroll
          for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + ls[r];
          wgmma_wait_all();
          fence_regs(o);
          release(bar_empty + 8 * prev);
          pack_p<kBK>(pa, s);
          prev = stage;
          prev_phase = phase;
          advance();
        }
        // the last tile's PV product
        rescale<D>(o, al);
        if (P::kSplitKV) mbar_wait(bar_v_full + 8 * prev, prev_phase);
        fence_regs(o);
        wgmma_fence();
        pv_issue<D>(o, pa, sKV + (2 * prev + 1) * P::kTileBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        release(bar_empty + 8 * prev);

        const float inv0 = 1.f / fmaxf(quad_sum(l[0]), 1e-30f);
        const float inv1 = 1.f / fmaxf(quad_sum(l[1]), 1e-30f);
        __nv_bfloat16* ob = p.o + it.b * p.os.b + it.h * p.os.h;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          if (r0 < p.Sq)
            *reinterpret_cast<uint32_t*>(ob + r0 * p.os.s + j * 8 + t * 2) =
                pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
          if (r0 + 8 < p.Sq)
            *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * p.os.s + j * 8 +
                                         t * 2) =
                pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
        }
      }
      // the block's tiles past this warpgroup's rows: pass them on (and
      // the turns) without computing
      for (int kt = n_kt; kt < it.n_kt; ++kt) {
        mbar_wait(bar_k_full + 8 * stage, phase);
        if (P::kSplitKV) mbar_wait(bar_v_full + 8 * stage, phase);
        turn_begin();
        turn_end();
        release(bar_empty + 8 * stage);
        advance();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: one thread per query row, exact float32 products
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per staged tile

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
  const int nq = (p.Sq + kBQ - 1) / kBQ;
  return p.causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
}

// key tiles up to the position of the tile's last row (Sk - Sq + row)
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  const int n = (p.Sk + kBK - 1) / kBK;
  return p.causal ? min(n, (q0 + kBQ - 1 + p.Sk - p.Sq) / kBK + 1) : n;
}

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
  const int pos = row + p.Sk - p.Sq;   // the row's key position
  const float* kb = static_cast<const float*>(p.k) + b * p.ks.b +
                    kvh * p.ks.h;
  const float* vb = static_cast<const float*>(p.v) + b * p.vs.b +
                    kvh * p.vs.h;

  float q[D], acc[D];
  const float* qr = static_cast<const float*>(p.q) + b * p.qs.b +
                    h * p.qs.h + (long long)min(row, p.Sq - 1) * p.qs.s;
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
    load_tile<float, D, D, kBK, kBQ>(sK, kb, p.ks.s, k0, p.Sk);
    load_tile<float, D, D, kBK, kBQ>(sV, vb, p.vs.s, k0, p.Sk);
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
        if (key >= p.Sk || (p.causal && key > pos)) v = kNegInf;
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
  if (row < p.Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h +
                  (long long)row * p.os.s;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                            cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// A (D, S, heads, B) map over a strided bf16 view (S = Sq for q, Sk for k
// and v); boxes of kBoxD columns by `box_rows` rows, swizzled as the wgmma
// descriptors read them. Rows past S read as zeros.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int S, int heads, int B,
              const Strides& st, int box_rows) {
  using P = Plan<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                           (cuuint64_t)st.b * 2};
  // a dimension of extent 1 is never stepped: give it a stride TMA takes
  // (a view may carry 0 or anything there)
  cuuint64_t widest = 16;
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] > 1 && strides[i] > widest) widest = strides[i];
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = widest;
  const cuuint32_t box[4] = {(cuuint32_t)P::kBoxD, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      P::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : P::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kErrTensorMap = -1;  // no driver entry point, or a bad map
constexpr int kMaxDevices = 16;    // devices whose launch state is kept
constexpr int kErrPlan = -2;       // the caller's plan is not the kernel's

template <int D>
int launch_bf16(const Params& p, const int* plan, cudaStream_t stream) {
  using P = Plan<D>;
  if (plan[0] != P::kBQ || plan[1] != P::kBK || plan[2] != P::kStages ||
      plan[3] != P::kThreads || plan[4] != P::kSmem)
    return kErrPlan;
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, p.q, p.Sq, p.H, p.B, p.qs, P::kBQ) ||
      !make_map<D>(&tk, p.k, p.Sk, p.KV, p.B, p.ks, P::kBK) ||
      !make_map<D>(&tv, p.v, p.Sk, p.KV, p.B, p.vs, P::kBK))
    return kErrTensorMap;
  Shape s{p.B, p.H, p.KV, p.Sq, p.Sk, p.causal, p.scale,
          static_cast<__nv_bfloat16*>(p.o), p.os};
  // the SM count, and the shared-memory attribute (which holds for the
  // current device only), kept per device: set on a device's first launch
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  static std::atomic<int> sms_of[kMaxDevices];
  int sms = sms_of[device].load();
  if (sms == 0) {
    cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         P::kSmem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    sms_of[device].store(sms);
  }
  // persistent: one block an SM walks the work items (counted in int)
  const long long items =
      (long long)((p.Sq + P::kBQ - 1) / P::kBQ) * p.B * p.H;
  if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  flash_wgmma_kernel<D><<<grid, P::kThreads, P::kSmem, stream>>>(tq, tk, tv,
                                                                  s);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H);
  const int smem = 2 * kBK * D * (int)sizeof(float);
  cudaFuncSetAttribute(flash_f32_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  flash_f32_kernel<D><<<grid, kBQ, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Params& p, int is_bf16, const int* plan,
           cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(p, plan, stream) : launch_f32<D>(p, stream);
}

}  // namespace

// Launches attention on `stream`; returns cudaGetLastError() (0 =
// launched), -1 if the TMA maps could not be built, -2 if `plan` (block
// rows, keys per stage, stages, threads, shared bytes; bf16 only) is not
// the kernel's. Strides are in elements, in (batch, head, sequence) order.
// The caller validates: one dtype (bf16 if is_bf16, else float32), unit
// last strides, 16-byte aligned data and strides, H % KV == 0,
// B*H <= 65535, 1 <= Sq <= Sk and D in {16, 32, 64, 128}.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int is_bf16, const int* plan, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.scale = 1.0f / sqrtf((float)D);
  p.qs = {q_sb, q_sh, q_ss};
  p.ks = {k_sb, k_sh, k_ss};
  p.vs = {v_sb, v_sh, v_ss};
  p.os = {o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, is_bf16, plan, s);
    case 32: return launch<32>(p, is_bf16, plan, s);
    case 64: return launch<64>(p, is_bf16, plan, s);
    case 128: return launch<128>(p, is_bf16, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
