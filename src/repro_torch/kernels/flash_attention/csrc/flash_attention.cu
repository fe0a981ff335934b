// Flash attention forward on the H100's float32 CUDA cores: blockwise
// online softmax, GQA, causal and sliding-window masks (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _flash_kernel).  For q [B, H, S, D] and k, v [B, KH, T, D], query
// head h reading kv head h / G (G = H / KH), query i sees key j when j < T,
// j <= i (causal) and j > i - window (window >= 0):
//   s = (q * c) . k with c = scale * log2(e) (one float32 product), masked
//     keys set to NEG_INF = -1e30;
//   per kv tile: m' = max(m, max_j s);  alpha = exp2(m - m');
//     p = exp2(s - m'), forced to 0 on masked keys;
//     l = l * alpha + sum p;  acc = acc * alpha + p . v;
//   out = acc / max(l, 1e-30) (rows with no valid key give 0),
// with float32 running max, sum and accumulator whatever the input type
// (float32 or bfloat16; the output is rounded with __float2bfloat16_rn).
// This is the reference's softmax in base 2: exp2((q . k) scale log2(e) -
// m) = exp((q . k) scale - m / log2(e)).
//
// This is the CUDA-core kernel: the wrapper (kernel.py) sends it float32
// inputs and bfloat16 inputs with head dim 16 or 32.  bfloat16 at head dim
// 64 or 128 goes to flash_attention_sm90.cu (wgmma, TMA).
//
// Bound: operations.  A causal call does 4 H D S (S + 1) / 2 flops per
// batch row (two dot products of length D per valid (query, key) pair) and
// moves q, k, v and out once.  At granite's prefill shape (B = 1, H = 16,
// KH = 8, S = 32768, D = 64, float32) that is 2.199e12 flops, 32.8 ms at
// the card's float32 rate of 67 TFLOP/s (0.4 GB moved: 0.12 ms at 3.35
// TB/s).  At its training shape (B = 8, S = 512) it is 4.303e9 flops,
// 0.064 ms.  So the work is FMAs on the CUDA cores, and the design keeps
// them fed:
//
//   * Head-group CTAs.  One CTA of 256 threads (8 warps) per (kv head,
//     batch row, query block) covers GC of the G query heads that read that
//     kv head: GC is the largest power of two dividing G, at most 8, and
//     the CTA's 128 rows are GC heads x BQ = 128 / GC queries (G = 1: 1 x
//     128, G = 2: 2 x 64, G = 4: 4 x 32, G = 8: 8 x 16; G = 7: 1 x 128,
//     seven CTAs per kv head).  Row r is head r / BQ, query q0 + r % BQ;
//     each warp's 16 rows lie in one head.  The heads share the query
//     positions, so one staged K/V tile, one mask pattern and one range of
//     tiles serve them all: K and V are read once per GC heads, not once
//     per head.
//   * Longest first.  The query block is the grid's slowest axis, taken
//     from the last: CTAs start in x-fastest order, so under a causal mask
//     the CTAs that see the most keys start first over every head and
//     batch row, and the short ones fill the tail.
//   * Register tiles.  Lane (rg, kg) = (lane / 8, lane % 8) of warp w
//     holds rows 16 w + rg + 4 i (i < 4).  In S = Q K^T it holds keys
//     kg + 8 c (c < BK / 8 = 4): per 4 dims, 4 float4 loads of K and 4 of
//     Q feed 64 FMAs (8 per 16-byte load).  In O += P V it holds D / 8 dims
//     of its 4 rows, (8 c + kg) VW .. + VW, VW = 4 when 4 divides D / 8,
//     else 2 (D = 16: 2; D = 80: 2 x 5 per lane): per 4 keys, 4 float4
//     loads of P and 4 D / (8 VW) vector loads of V feed 16 D / 8 FMAs
//     (D = 64: 128 FMAs, 12 loads).  The row max is reduced over the row's
//     8 lanes by __shfl_xor_sync; l is kept per lane and summed once at
//     the end.  P passes from the S layout to the O layout through the
//     warp's own slice of shared memory (a __syncwarp, no CTA barrier).
//     Row strides are padded by 16 bytes (Q, K, V) or 32 bytes (P) so that
//     a warp's loads and P stores are free of bank conflicts: the 8 keys or
//     rows a warp reads at once are consecutive rows whose starts fall 4
//     banks apart.
//   * Asynchronous K/V copies.  K and V tiles of BK = 32 keys go through a
//     ring of NSTAGE = 2 stages filled by 16-byte cp.async.cg copies (keys
//     past T zero-filled by the copy), in the input's type: a bfloat16
//     tile is widened to float32 as it is read from shared memory.  Tile
//     t + 1 is in flight while tile t is computed; one __syncthreads per
//     tile.  Q is staged once, times c, as float32, with all of a thread's
//     loads in flight at once.  The wrapper gives this kernel only 16-byte
//     aligned rows (kernel.py, async_copy_ready; others are first copied
//     into a contiguous clone).
//   * Softmax in base 2: c = scale * log2(e) is folded into Q once, and
//     the exponentials are single ex2.approx.ftz instructions (as in
//     flash_attention_sm90.cu; exp2f's subnormal handling costs time, and
//     a p below 2^-126 adds nothing the output can show).
//   * Only tiles that some row of the CTA can see are staged, and a warp
//     computes only those that some row of its own can see (a tile masked
//     for every row of a warp would leave its m, l and acc as they were);
//     the mask is evaluated only on tiles that cross a mask edge or the end
//     of T, for the warp's rows.
//   * Deterministic.  One CTA owns every row's whole reduction, in a fixed
//     order: no split over keys, no atomics, so a repeat is bit-identical.
//   * Registers and occupancy: __launch_bounds__(256, 2) at D <= 64 (at
//     most 128 registers a thread, two CTAs an SM: 16 warps; shared memory
//     88 KB a CTA at D = 64), (256, 1) at D = 80 (104 KB) and D = 128 (152
//     KB).  The copy and
//     staging loops are kept rolled, which leaves ptxas no spill at 128
//     registers.  ptxas -v (kernels/_build.py) reports registers and
//     spills; chip_smoke.py fails on a spill store and reports the CTAs
//     per SM (flash_attention_occupancy).
//
// What bounds it on the card, as the variants timed in PERF.md read: the
// times fit shared memory delivering 128 bytes an SM a cycle (32 lanes x
// 4 bytes, broadcast or not) against 128 FMAs a cycle, which keeps the
// FMA units fed only at 4 FMAs per float a lane loads.  These tiles give
// 2 (S: 4 x 4) and 2.67 (P V: 4 x 8), a cap near 0.57 of the float32
// peak.  Tiles of 8 x 8 reach 4 but need about twice the registers, so
// half the warps, and then the loads' latency is not hidden.
//
// Any S and T are accepted: rows past S compute and are not stored, keys
// past T are masked.  q, k, v and out are addressed through their batch,
// head and sequence strides (the last axis contiguous), so the model's
// [B, S, H, D] tensors need no transpose.  The dot products are written
// with fmaf; this kernel has no bit-exactness contract against the plain
// version (ref.py), which it matches to rounding, and its build leaves
// multiply-adds free to fuse (no -fmad=false).
//
// Instantiated: head dims 16, 32, 64, 80 (zamba2's shared attention) and
// 128 in float32; 16 and 32 in bfloat16.  Nothing here needs a power of
// two: D / 4 (Q staging, S's dims, the copies) and D / 8 / VW (O's
// vectors) are whole for each.  The C entry launches on the caller's stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not
// instantiate), which the ctypes wrapper turns into an exception.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                // threads of a CTA
constexpr int NW = NT / 32;            // warps of a CTA
constexpr int ROWS = 128;              // (head, query) rows of a CTA
constexpr int WROWS = ROWS / NW;       // rows of a warp
constexpr int RT = 4;                  // rows of a lane: rg + 4 i
constexpr int BK = 32;                 // keys of a K/V tile
constexpr int KT = BK / 8;             // keys of a lane in S: kg + 8 c
constexpr int NSTAGE = 2;              // K/V ring stages
constexpr int PSTR = BK + 8;           // floats per row of P
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int S, T, G, GC, BQ;  // GC heads of G per CTA, BQ = ROWS / GC queries
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  int causal, window;  // window < 0: no window
  float c;             // scale * log2(e)
};

template <int D, typename T>
struct Cfg {
  static constexpr int EPC = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int QSTR = D + 4;             // floats per row of Q
  static constexpr int KSTR = D + EPC;           // elements per K/V row
  static constexpr int DL = D / 8;               // dims of a lane in O
  static constexpr int VW = DL % 4 == 0 ? 4 : 2; // its vector width
  static_assert(D % 8 == 0 && DL % VW == 0, "head dim");
  static constexpr size_t Q_BYTES = (size_t)ROWS * QSTR * 4;
  static constexpr size_t KV_BYTES = (size_t)NSTAGE * BK * KSTR * sizeof(T);
  static constexpr size_t P_BYTES = (size_t)NW * WROWS * PSTR * 4;
  static constexpr size_t SMEM = Q_BYTES + 2 * KV_BYTES + P_BYTES;
  static constexpr int MIN_CTAS = D <= 64 ? 2 : 1;
};

// N consecutive elements as floats, from shared or global memory (16-, 8-
// or 4-byte aligned vector loads).
template <int N>
__device__ __forceinline__ void load(const float* p, float* x) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
  // a bf16 is the top half of a float32: widening is a shift
  if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(t.x << 16);
    x[1] = __uint_as_float(t.x & 0xffff0000u);
    x[2] = __uint_as_float(t.y << 16);
    x[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    x[0] = __uint_as_float(t << 16); x[1] = __uint_as_float(t & 0xffff0000u);
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float* x) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);  // .x = a, low half
  return *reinterpret_cast<const uint32_t*>(&t);
}
template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
  if constexpr (N == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  else
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x[0], x[1]);
}

// 2^x on the special-function unit; subnormal inputs and results are
// flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One 16-byte asynchronous copy global -> shared; zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool key_ok(int qi, int kj, const Params& p) {
  return kj < p.T && (!p.causal || qi >= kj) &&
         (p.window < 0 || kj > qi - p.window);
}

// The tiles [lo, hi) holding a key that some query first..last may see.
__device__ __forceinline__ void tile_range(int first, int last,
                                           const Params& p, int& lo,
                                           int& hi) {
  const int lo_key = p.window >= 0 ? max(first - p.window + 1, 0) : 0;
  const int hi_key = p.causal ? min(p.T - 1, last) : p.T - 1;
  lo = lo_key / BK;
  hi = (last < first || hi_key < lo_key) ? lo : hi_key / BK + 1;
}

// Issue the copies of keys k0 .. k0 + BK - 1 of K and V into one stage.
template <int D, typename T>
__device__ __forceinline__ void copy_tile(T* ks, T* vs, const T* kp,
                                          const T* vp, int k0,
                                          const Params& p) {
  using C = Cfg<D, T>;
  constexpr int CPR = D / C::EPC;  // 16-byte copies per row
#pragma unroll 1
  for (int i = threadIdx.x; i < BK * CPR; i += NT) {
    const int j = i / CPR, e = (i % CPR) * C::EPC;
    const bool in = k0 + j < p.T;
    const int64_t key = in ? k0 + j : 0;
    cp_async16(ks + j * C::KSTR + e, kp + key * p.ks + e, in);
    cp_async16(vs + j * C::KSTR + e, vp + key * p.vs + e, in);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT, Cfg<D, T>::MIN_CTAS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Params p) {
  using C = Cfg<D, T>;
  constexpr int DL = C::DL, VW = C::VW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                // [ROWS][QSTR]
  T* k_s = reinterpret_cast<T*>(smem + C::Q_BYTES);  // [NSTAGE][BK][KSTR]
  T* v_s = reinterpret_cast<T*>(smem + C::Q_BYTES + C::KV_BYTES);
  float* p_s = reinterpret_cast<float*>(smem + C::Q_BYTES + 2 * C::KV_BYTES);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, kg = lane % 8;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * p.BQ;  // longest first
  const int h0 = blockIdx.x * p.GC;                    // the CTA's 1st head
  const int b = blockIdx.y;
  const T* kp = k + b * p.kb + (h0 / p.G) * p.kh;
  const T* vp = v + b * p.vb + (h0 / p.G) * p.vh;

  int lo, hi;  // the CTA's tiles
  tile_range(q0, min(q0 + p.BQ, p.S) - 1, p, lo, hi);
  const int n = hi - lo;
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < n)
      copy_tile<D, T>(k_s + st * BK * C::KSTR, v_s + st * BK * C::KSTR, kp,
                      vp, (lo + st) * BK, p);
    cp_async_commit();
  }

  // Q times c as float32, row r = (head h0 + r / BQ, query q0 + r % BQ)
  {
    constexpr int QN = ROWS * (D / 4) / NT;  // 4-element pieces a thread
    float x[QN][4];
#pragma unroll
    for (int u = 0; u < QN; ++u) {
      const int i = u * NT + threadIdx.x;
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
      const int qi = q0 + r % p.BQ;
#pragma unroll
      for (int e = 0; e < 4; ++e) x[u][e] = 0.0f;
      if (qi < p.S)
        load<4>(q + b * p.qb + (h0 + r / p.BQ) * p.qh + qi * p.qs + d, x[u]);
    }
#pragma unroll
    for (int u = 0; u < QN; ++u) {
      const int i = u * NT + threadIdx.x;
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) x[u][e] *= p.c;
      store<4>(q_s + r * C::QSTR + d, x[u]);
    }
  }

  // this warp's rows: one head, queries qw0 .. qw0 + 15
  const int wr0 = warp * WROWS;
  const int qw0 = q0 + wr0 % p.BQ;
  const int qw_last = min(qw0 + WROWS, p.S) - 1;
  int wlo, whi;
  tile_range(qw0, qw_last, p, wlo, whi);
  const float* qw = q_s + (wr0 + rg) * C::QSTR;
  float* pw = p_s + (warp * WROWS + rg) * PSTR;  // row rg of the warp's P

  float m[RT], l[RT], acc[RT][DL];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[i][d] = 0.0f;
  }

  for (int it = 0; it < n; ++it) {
    cp_async_wait<NSTAGE - 2>();  // this thread's copies of tile it
    __syncthreads();              // everyone's; stage it - 1 is consumed
    {
      const int nx = it + NSTAGE - 1, st = nx % NSTAGE;
      if (nx < n)
        copy_tile<D, T>(k_s + st * BK * C::KSTR, v_s + st * BK * C::KSTR,
                        kp, vp, (lo + nx) * BK, p);
      cp_async_commit();
    }
    const int kb = lo + it;
    if (kb < wlo || kb >= whi) continue;  // no key for any row of the warp
    const int k0 = kb * BK;
    const T* kt = k_s + (it % NSTAGE) * BK * C::KSTR;
    const T* vt = v_s + (it % NSTAGE) * BK * C::KSTR;

    // S = (Q c) K^T: rows rg + 4 i, keys kg + 8 c
    float s[RT][KT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < KT; ++c) s[i][c] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float kv[KT][4];
#pragma unroll
      for (int c = 0; c < KT; ++c)
        load<4>(kt + (kg + 8 * c) * C::KSTR + d, kv[c]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float qv[4];
        load<4>(qw + 4 * i * C::QSTR + d, qv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < KT; ++c)
            s[i][c] = fmaf(qv[e], kv[c][e], s[i][c]);
      }
    }

    // does some (row, key) pair of the warp's tile fall outside the mask?
    const bool edge = k0 + BK > p.T || (p.causal && k0 + BK - 1 > qw0) ||
                      (p.window >= 0 && k0 <= qw_last - p.window);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qi = qw0 + rg + 4 * i;
      float mt = NEG_INF;
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        if (edge && !key_ok(qi, k0 + kg + 8 * c, p)) s[i][c] = NEG_INF;
        mt = fmaxf(mt, s[i][c]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = ex2(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        float pc = ex2(s[i][c] - m_new);
        if (edge && !key_ok(qi, k0 + kg + 8 * c, p)) pc = 0.0f;
        sum += pc;
        pw[4 * i * PSTR + kg + 8 * c] = pc;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[i][d] *= alpha;
      m[i] = m_new;
    }
    __syncwarp();  // the warp's P rows are written (the next tile's
                   // writes wait for the __syncthreads above)

    // O += P V: rows rg + 4 i, dims (8 c + kg) VW .. + VW
#pragma unroll
    for (int j = 0; j < BK; j += 4) {
      float pv[RT][4];
#pragma unroll
      for (int i = 0; i < RT; ++i) load<4>(pw + 4 * i * PSTR + j, pv[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DL];
#pragma unroll
        for (int c = 0; c < DL / VW; ++c)
          load<VW>(vt + (j + jj) * C::KSTR + (8 * c + kg) * VW, vv + c * VW);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int d = 0; d < DL; ++d)
            acc[i][d] = fmaf(pv[i][jj], vv[d], acc[i][d]);
      }
    }
  }

  // l over the row's 8 lanes, then out = acc / max(l, 1e-30)
  T* ow = o + b * p.ob + (h0 + wr0 / p.BQ) * p.oh;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(FULL, li, 1);
    li += __shfl_xor_sync(FULL, li, 2);
    li += __shfl_xor_sync(FULL, li, 4);
    const int qi = qw0 + rg + 4 * i;
    if (qi < p.S) {
      const float den = fmaxf(li, 1e-30f);
#pragma unroll
      for (int c = 0; c < DL / VW; ++c) {
        float x[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) x[e] = acc[i][c * VW + e] / den;
        store<VW>(ow + qi * p.os + (8 * c + kg) * VW, x);
      }
    }
  }
}

// Heads of a kv head's group that one CTA covers: the largest power of two
// dividing G, at most 8.
int heads_per_cta(int G) {
  int gc = 1;
  while (gc < 8 && G % (2 * gc) == 0) gc *= 2;
  return gc;
}

template <int D, typename T>
int set_smem() {
  constexpr size_t smem = Cfg<D, T>::SMEM;
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(flash_attention_kernel<D, T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

struct Launch {
  const void *q, *k, *v;
  void* o;
  int B, H;
  const Params& p;
  cudaStream_t stream;
  template <int D, typename T>
  int run() const {
    const int err = set_smem<D, T>();
    if (err != (int)cudaSuccess) return err;
    dim3 grid(H / p.GC, B, (p.S + p.BQ - 1) / p.BQ);
    flash_attention_kernel<D, T><<<grid, NT, Cfg<D, T>::SMEM, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, p);
    return (int)cudaGetLastError();
  }
};

struct Occupancy {
  int* ctas;
  template <int D, typename T>
  int run() const {
    const int err = set_smem<D, T>();
    if (err != (int)cudaSuccess) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, flash_attention_kernel<D, T>, NT, Cfg<D, T>::SMEM);
  }
};

// f.run<D, T>() for the seven instantiated (dtype, D) pairs.
template <typename F>
int dispatch(int dtype, int D, const F& f) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0) {
    switch (D) {
      case 16: return f.template run<16, float>();
      case 32: return f.template run<32, float>();
      case 64: return f.template run<64, float>();
      case 80: return f.template run<80, float>();
      case 128: return f.template run<128, float>();
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return f.template run<16, bf16>();
      case 32: return f.template run<32, bf16>();
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, sequence) of q, k, v and out.
// dtype: 0 = float32, 1 = bfloat16.  window < 0: no window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KH, int S, int T, int D,
                        const long long* strides, int causal, int window,
                        float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return (int)cudaSuccess;
  if (KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.S = S;
  p.T = T;
  p.G = H / KH;
  p.GC = heads_per_cta(p.G);
  p.BQ = ROWS / p.GC;
  p.qb = strides[0]; p.qh = strides[1]; p.qs = strides[2];
  p.kb = strides[3]; p.kh = strides[4]; p.ks = strides[5];
  p.vb = strides[6]; p.vh = strides[7]; p.vs = strides[8];
  p.ob = strides[9]; p.oh = strides[10]; p.os = strides[11];
  p.causal = causal;
  p.window = window;
  p.c = scale * 1.44269504088896341f;  // log2(e), one float32 product
  return dispatch(dtype, D, Launch{q, k, v, o, B, H, p,
                                   (cudaStream_t)stream});
}

// CTAs of the (dtype, D) instantiation that fit on one SM at once.
int flash_attention_occupancy(int dtype, int D, int* ctas) {
  return dispatch(dtype, D, Occupancy{ctas});
}

}  // extern "C"
