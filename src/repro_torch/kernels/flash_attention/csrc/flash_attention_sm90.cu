// Flash attention forward on Hopper's bf16 tensor cores (sm_90a): wgmma
// for both products, K/V tiles staged by TMA through a shared-memory ring.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _flash_kernel) for bfloat16 inputs with head dim 64, 80 or 128;
// the wrapper (kernel.py) sends float32 and other head dims to the
// CUDA-core kernel flash_attention.cu.  It computes what that kernel and the
// reference compute.  For q [B, H, S, D] and k, v [B, KH, T, D], query head
// h reads kv head h / (H / KH), and query i sees key j when j < T, j <= i
// (causal) and j > i - window (window >= 0).  Masked keys get p = 0, rows
// with no key give 0, and the output is out = O / max(l, 1e-30), rounded
// with __float2bfloat16_rn.  The softmax runs in base 2: s = (q . k) *
// scale * log2(e) in float32, p = exp2(s - m).
//
// One more instance has no TPU counterpart: q/k head dim 192 with v head
// dim 128 (v [B, KH, T, 128], out [B, H, S, 128]), DeepSeek-V3's latent
// attention (MLA) as Moonlight-16B-A3B runs it, with q and k's no-RoPE 128
// and RoPE 64 columns side by side; the wrapper passes scale = 1/sqrt(192).
// The kernel is templated on the two widths, <DQK, DV>; the D = 64, 80 and
// 128 instances have DQK = DV = D (below, D is either where they agree).
//
// Bound: operations.  A causal call does 4 H D S (S + 1) / 2 flops per batch
// row and moves q, k, v and out once.  At granite's prefill shape (S =
// 32768, H = 16, KH = 8, D = 64) that is 2.2e12 flops against 0.20 GB: 2.22
// ms at the card's dense bf16 rate of 989 TFLOP/s, 0.06 ms at 3.35 TB/s.
// The (192, 128) instance does 2 H (192 + 128) flops per (query, key) pair:
// at Moonlight's prefill (B = 8, S = 8192, H = KH = 16) 2.75e12 flops
// against 1.34 GB, 2.78 ms at 989 TFLOP/s.
//
// Accuracy.  q . k of bf16 operands is exact in the f32 accumulator up to
// the order of the additions.  P . V does not round P to bf16, which would
// cost up to 2^-9 of each p and fail the bf16-output gate of the tests.  P
// is split as p_hi = bf16(p) and p_lo = bf16(p - p_hi), and O += p_hi V +
// p_lo V runs as two wgmmas on the same V tile.  What is left of p is at
// most 2^-16 |p| (2^-134 absolute where p - p_hi falls below bf16's
// normal range), the size of f32 reordering.  The price is 1.5x the
// tensor-core work: a floor of 3.34 ms at the prefill shape.
//
// Design:
//   * One CTA of 288 threads per (128-query block, head, batch row), the
//     heaviest causal blocks first.  Warps 0-7 are two consumer
//     warpgroups of 64 query rows each, and warp 8 is the producer: one
//     lane issues every TMA load.
//   * Q is loaded once by TMA.  K and V tiles of BK keys (128 at D = 64,
//     64 at D = 128) go through a 2-stage ring.  Each stage has its own
//     K and V "full" mbarriers (TMA transaction bytes) and one "empty"
//     mbarrier that all 256 consumer threads arrive on.  The tensor maps
//     are 4-D (D, sequence, head, batch) over the tensors' own strides, so
//     the model's [B, S, H, D] projections need no copy.  They use the
//     128-byte swizzle in 64-column panels (two panels at D = 128), and
//     TMA zero-fills the ragged edge.
//   * S = Q K^T: wgmma m64nBKk16, A = Q and B = K from shared memory (both
//     K-major), one instruction per 16 of D.  The descriptor of k-step kk
//     starts 32 bytes further into the swizzled 128-byte row (the panel is
//     1024-byte aligned, so the swizzle phase is unchanged).
//   * Online softmax on the accumulator fragment.  Thread (warp w, lane)
//     holds rows 16w + lane/4 and +8, with columns 8j + 2(lane%4) + {0, 1}.
//     The row max takes two quad shuffles.  The exponentials are single
//     ex2.approx.ftz instructions (exp2f's subnormal handling cost 17% of
//     the kernel's time at the prefill shape on an H100 SXM).  l is kept
//     per thread and summed over the quad at the end.  The mask is
//     evaluated only on tiles that cross a mask edge or the end of T.  A
//     tile with no key for any row of a warpgroup is not computed by that
//     warpgroup (it leaves m, l and O as they were).
//   * O += P V: the S accumulator converts in place to the register A
//     fragment of m64nDk16 (4 bf16x2 registers per 16 keys), once for p_hi
//     and once for p_lo.  B = V is MN-major (D contiguous), which bf16
//     wgmma reads through its transpose bit.  In the descriptor, SBO = 1024
//     bytes (8 keys) and LBO = the next 64-column panel.
//   * Epilogue: O / max(l, 1e-30) stored as bf16x2 through out's strides;
//     rows >= S and columns >= d_valid are not stored.
//   * Head dim 80 (zamba2's shared attention) runs the D = 128 kernel over
//     tensor maps whose global extent is 80 columns: the second panel's
//     box (columns 64-127) reads 16 columns and TMA fills the other 48
//     with zeros.  Zero columns of Q and K leave Q K^T exact, zero columns
//     of V give zero output columns, which the epilogue does not store
//     (d_valid = 80).  The tensor cores do 128/80 = 1.6x the work of the
//     head dim; a 80-wide tile (m64n80 for P V, five 16-column k-steps for
//     Q K^T in a panel of its own) is left for later.
//   * (DQK, DV) = (192, 128) keeps the D = 128 instance's tiles and
//     registers (BK = 64; 32 scores, 64 of O, 32 of P a thread): Q and K
//     tiles are three 64-column panels and S = Q K^T takes 12 k-steps, V
//     tiles two panels and O is m64n128.  Shared memory: Q 48 KB and two
//     stages of K (24 KB) and V (16 KB), 128 KB.
// Each warpgroup waits for its own products, so its softmax overlaps only
// the other warpgroup's products.  Left for later: overlapping a tile's
// softmax with the next tile's products in the same warpgroup, with the
// warpgroups taking turns (pingpong).  That needs a second set of score
// registers, and at 288 threads ptxas caps a thread at 168 registers (this
// kernel uses 163 at D = 64, 153 at D = 128, no spills).  A pipelined form
// spilled and ran slower, so it waits for setmaxnreg with a full producer
// warpgroup.  Persistent CTAs are also left for later.
//
// The C entry builds the tensor maps on the host per call
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so no
// -lcuda), launches on the caller's stream and returns cudaGetLastError()
// (10000 + the CUresult when a tensor map cannot be encoded), which the
// ctypes wrapper turns into an exception.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define LOG2E 1.4426950408889634f

constexpr int BQ = 128;         // query rows per CTA
constexpr int NST = 2;          // stages of the K/V ring
constexpr int CONSUMERS = 256;  // threads of the two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int PANEL = 64;       // bf16 columns of one 128-byte swizzle row

template <int DQK, int DV>
struct Cfg {
  static constexpr int BK = DQK == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BK * DQK * 2;     // one K tile
  static constexpr int V_BYTES = BK * DV * 2;      // one V tile
  static constexpr int SMEM = Q_BYTES + NST * (K_BYTES + V_BYTES);
};

struct Params {
  int S, T, G, causal, window;  // window < 0: no window
  int d_valid;                  // columns of v and out (<= DV)
  float scale_log2;             // scale * log2(e), scale = 1/sqrt(DQK)
  __nv_bfloat16* o;
  int64_t ob, oh, os;           // out's batch, head, sequence strides
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in bytes here, encoded in 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x on the special-function unit; subnormal inputs and results are
// flushed to 0 (a p below 2^-126 adds nothing the output can show).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep registers that an asynchronous wgmma reads or writes in place
// across its issue and its wait (the compiler does not see the asynchrony).
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A.B, A and B from shared memory (descriptors), m64n64k16.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B, A from registers (4 x bf16x2), B from shared memory, MN-major
// (transposed), m64n64k16.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (+)= A.B, A and B from shared memory (descriptors), m64n128k16.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B, A from registers (4 x bf16x2), B from shared memory, MN-major
// (transposed), m64n128k16.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ bool key_ok(int qi, int kj, const Params& p) {
  return kj < p.T && (!p.causal || qi >= kj) &&
         (p.window < 0 || kj > qi - p.window);
}

// The kv tiles [x, y) holding a key that some row r0 .. r0 + rows - 1 below
// S may see (empty when there is none).
__device__ __forceinline__ int2 kv_tiles(int r0, int rows, int bk,
                                         const Params& p) {
  const int r_last = min(r0 + rows, p.S) - 1;
  const int lo_key = p.window >= 0 ? max(r0 - p.window + 1, 0) : 0;
  const int hi_key = p.causal ? min(p.T - 1, r_last) : p.T - 1;
  if (r_last < r0 || hi_key < lo_key) return make_int2(0, 0);
  return make_int2(lo_key / bk, hi_key / bk + 1);
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const Params p) {
  using C = Cfg<DQK, DV>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[NST], v_full[NST],
      empty[NST];
  // 128-byte swizzled tiles start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;  // DQK / 64 panels of [BQ rows][128 B]

  const int tid = threadIdx.x;
  const int qblk = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const int q0 = qblk * BQ;
  const int2 cta = kv_tiles(q0, BQ, BK, p);

  if (tid == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int st = 0; st < NST; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues the loads
    if (tid == CONSUMERS) {
      mbar_expect_tx(&q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DQK / PANEL; ++c)
        tma_load(q_s + c * BQ * 128, &tq, &q_full, c * PANEL, q0, h, b);
      for (int kb = cta.x, it = 0; kb < cta.y; ++kb, ++it) {
        const int st = it % NST;
        if (it >= NST) mbar_wait(&empty[st], ((it / NST) - 1) & 1);
        uint8_t* k_s = smem + C::Q_BYTES + st * (C::K_BYTES + C::V_BYTES);
        uint8_t* v_s = k_s + C::K_BYTES;
        mbar_expect_tx(&k_full[st], C::K_BYTES);
#pragma unroll
        for (int c = 0; c < DQK / PANEL; ++c)
          tma_load(k_s + c * BK * 128, &tk, &k_full[st], c * PANEL, kb * BK,
                   kvh, b);
        mbar_expect_tx(&v_full[st], C::V_BYTES);
#pragma unroll
        for (int c = 0; c < DV / PANEL; ++c)
          tma_load(v_s + c * BK * 128, &tv, &v_full[st], c * PANEL, kb * BK,
                   kvh, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows r0 .. r0 + 63
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int t4 = lane % 4;
  const int r0 = q0 + wg * 64;
  const int row0 = r0 + warp * 16 + lane / 4;  // and row0 + 8
  const int2 mine = kv_tiles(r0, 64, BK, p);
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  mbar_wait(&q_full, 0);
  __syncwarp();
  for (int kb = cta.x, it = 0; kb < cta.y; ++kb, ++it) {
    const int st = it % NST;
    const uint32_t phase = (it / NST) & 1;
    uint8_t* k_s = smem + C::Q_BYTES + st * (C::K_BYTES + C::V_BYTES);
    uint8_t* v_s = k_s + C::K_BYTES;
    mbar_wait(&k_full[st], phase);
    if (kb < mine.x || kb >= mine.y) {  // no key here for these rows
      mbar_wait(&v_full[st], phase);
      mbar_arrive(&empty[st]);
      continue;
    }
    __syncwarp();

    // S = Q K^T over DQK in steps of 16
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    const uint32_t k_addr = smem_u32(k_s);
    hold<BK / 2>(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss<BK>(s,
                   sw128_desc(q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32,
                              16, 1024),
                   sw128_desc(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32,
                              16, 1024),
                   kk > 0);
    wg_commit();
    wg_wait_all();
    hold<BK / 2>(s);

    // online softmax, base 2; s[4j + e] is row row0 + 8 (e >> 1), key
    // k0 + 8j + 2 t4 + (e & 1)
    const int k0 = kb * BK;
    const bool edge = k0 + BK > p.T || (p.causal && k0 + BK - 1 > r0) ||
                      (p.window >= 0 && k0 <= r0 + 63 - p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] *= p.scale_log2;
      if (edge && !key_ok(row0 + ((i >> 1) & 1) * 8,
                          k0 + (i >> 2) * 8 + 2 * t4 + (i & 1), p))
        s[i] = NEG_INF;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t p_hi[BK / 4], p_lo[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int r = (i >> 1) & 1;
      float e0 = ex2(s[i] - mx[r]), e1 = ex2(s[i + 1] - mx[r]);
      if (edge && s[i] == NEG_INF) e0 = 0.0f;  // exp2(NEG_INF - m) guard
      if (edge && s[i + 1] == NEG_INF) e1 = 0.0f;
      l[r] += e0 + e1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(e0, e1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[i / 2] = bf162_bits(hi);
      p_lo[i / 2] = bf162_bits(__floats2bfloat162_rn(e0 - hf.x, e1 - hf.y));
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += p_hi V + p_lo V over the tile's keys in steps of 16
    mbar_wait(&v_full[st], phase);
    __syncwarp();
    const uint32_t v_addr = smem_u32(v_s);
    hold<DV / 2>(o);
    hold<BK / 4>(p_hi);
    hold<BK / 4>(p_lo);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, BK * 128, 1024);
      wgmma_rs<DV>(o, p_hi + 4 * kk, dv);
      wgmma_rs<DV>(o, p_lo + 4 * kk, dv);
    }
    wg_commit();
    wg_wait_all();
    hold<DV / 2>(o);
    hold<BK / 4>(p_hi);
    hold<BK / 4>(p_lo);
    mbar_arrive(&empty[st]);
  }

  // epilogue: l over the quad, out = O / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row < p.S) {
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = p.o + b * p.ob + h * p.oh + row * p.os;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        if (8 * j < p.d_valid)  // d_valid is a multiple of 8
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] / den,
                                    o[4 * j + 2 * r + 1] / den);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The 4-D map (D, rows, heads, batch) of a bf16 tensor with element strides
// st = (batch, head, sequence), read in boxes of 64 columns x box_rows
// (columns past D read as zeros).
static int encode(EncodeTiled fn, CUtensorMap* map, const void* base, int D,
                  int rows, int heads, int B, const long long* st,
                  int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {PANEL, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// The (DQK, DV)-column kernel over q and k of dqk <= DQK columns and v of
// p.d_valid <= DV columns.
template <int DQK, int DV>
static int launch(const void* q, const void* k, const void* v, int B, int H,
                  int KH, const long long* strides, int dqk, Params p,
                  cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  int err = encode(fn, &tq, q, dqk, p.S, H, B, strides, BQ);
  if (!err) err = encode(fn, &tk, k, dqk, p.T, KH, B, strides + 3, C::BK);
  if (!err)
    err = encode(fn, &tv, v, p.d_valid, p.T, KH, B, strides + 6, C::BK);
  if (err) return err;
  const int smem = C::SMEM + 1024;  // + room to align to 1024 bytes
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((p.S + BQ - 1) / BQ, H, B);
  flash_attention_sm90_kernel<DQK, DV>
      <<<grid, THREADS, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

extern "C" {

// bfloat16 q [B, H, S, D], k [B, KH, T, D], v [B, KH, T, Dv], out [B, H, S,
// Dv]: D = Dv = 64, 80 (through the D = 128 kernel) or 128, or D = 192 with
// Dv = 128.  strides: 12 element strides, (batch, head, sequence) of q, k, v
// and out; each of q, k, v must be 16-byte aligned with strides of a
// multiple of 8 elements (the tensor maps').  window < 0: no window.
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int KH, int S, int T,
                             int D, int Dv, const long long* strides,
                             int causal, int window, float scale,
                             void* stream) {
  if (B == 0 || H == 0 || S == 0) return (int)cudaSuccess;
  if (KH <= 0 || H % KH != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.S = S;
  p.T = T;
  p.G = H / KH;
  p.causal = causal;
  p.window = window;
  p.d_valid = Dv;
  p.scale_log2 = scale * LOG2E;
  p.o = (__nv_bfloat16*)o;
  p.ob = strides[9];
  p.oh = strides[10];
  p.os = strides[11];
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64 && Dv == 64)
    return launch<64, 64>(q, k, v, B, H, KH, strides, D, p, s);
  if ((D == 80 || D == 128) && Dv == D)
    return launch<128, 128>(q, k, v, B, H, KH, strides, D, p, s);
  if (D == 192 && Dv == 128)
    return launch<192, 128>(q, k, v, B, H, KH, strides, D, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
