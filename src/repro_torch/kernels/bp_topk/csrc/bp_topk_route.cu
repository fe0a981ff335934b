// The backpressure gate of one MoE layer in one launch (sm_90a).
//
// Replaces src/repro/kernels/bp_topk/kernel.py::bp_topk (body
// _bp_topk_kernel) together with the router ops around it in
// src/repro/models/moe.py::_route (use_kernel=True): the selection bias,
// the expert counts and the H update.  From router logits [T, E] (float32
// or bfloat16, widened exactly in registers), H [E], steps [], the
// per-step capacity cap (float32) and the backpressure flag:
//   bias = H / max(cap, 1)            (0 when the flag is off);
//   per row: m = max s; probs = exp(s - m) / sum exp(s - m);
//   sel = probs - bias; the k largest sel, the lowest index on ties, in
//   order; w = their probs / max(sum in pick order, 1e-9);
//   idx written as int64, w in the logits' dtype (bf16 round-to-nearest-
//   even, as torch's .to() does);
//   counts = picks per expert (float32); H_new = max((H + counts) - cap, 0);
//   steps_new = steps + 1.
// The sigmoid scoring mode (score = 1; DeepSeek-V3's gate, which the JAX
// package does not have) replaces the softmax by probs = 1 / (1 + exp(-s))
// per logit, and the weights by their probs / max(sum in pick order, 1e-9)
// times `scale` (the routed scaling factor); the rest is the same.  The
// bias H / max(cap, 1) takes the place of noaux_tc's selection-only
// correction bias.
//
// Bound: bytes.  Per row it reads E logits and writes k int64 indices and k
// weights; the arithmetic is ~(8 + log E) E operations.  At a decode step
// (T = 4 slots, E = 32, k = 8) the call moves about 1 KB and is bound by
// launch latency, which is why the whole gate is one launch (the router
// around the standalone bp_topk was about 15 launches per layer); at the
// 32k prefill (bf16, E = 32) it moves 4.5 MB, 1.3 us at 3.35 TB/s.
//
// Design.  Three paths, chosen by the shape.
//   * T >= 16,384 rows of E = 32 or 64 (a prefill's gate; granite and
//     moonshot): four lanes per row, E / 4 entries each in registers; the
//     softmax sum follows ref.warp_sum's tree (three levels in a lane, two
//     across the four), and pick j is one pass of compares over the
//     entries after pick j - 1 plus two butterfly steps.  About a third of
//     the warp-per-row sort's instructions a row, whose sort (about 300
//     and 49 shuffles) bounds the time once rows are many.
//   * other shapes with E <= 256 and k <= 32 (a decode step's gate): one
//     warp per row, rows strided over a grid of at most eight 256-thread
//     blocks per SM, each warp loading its next row before it works on the
//     current one.  The row lives in registers, ceil(E/32) rounded up to
//     1, 2, 4 or 8 entries per lane (lane l holds l, l+32, ...).  Each
//     register column is sorted across the warp by a bitonic network on
//     (sel descending, index ascending), a strict total order, so the
//     order of equal values is the index order; columns fold into a
//     running top 32 (first-of against the reversed column, then a bitonic
//     merge).  Lane j then holds pick j; its prob is fetched from the
//     owner lane's registers with one shuffle per column: no global
//     re-read and one expf per entry.
//   * any other E and k: one warp per row, the row's probs and sel in
//     shared memory, k passes of a (value, index) butterfly argmax, each
//     masking its pick with -1e30, as the standalone bp_topk does.
// Counts: each block counts its picks in shared memory with integer
// atomics.  A grid of one block writes counts, H_new and steps + 1 from
// them.  A larger grid adds them to a persistent int32 workspace [1 + E]
// (ticket, counts) with integer atomics, exact in any order; the last
// block to take a ticket (after __threadfence) writes counts, H_new and
// steps + 1, and resets the workspace and the ticket for the next launch.
// H_new is a separate output: other blocks still read H.
//
// Bit-exactness with the plain version (ref.py::bp_topk_route_ref), in both
// modes: the softmax denominator is ref.warp_sum's order (per-lane partials in stride
// order, then halving adds over the lanes), the weights' sum runs in pick
// order j = 0..k-1, every add, subtract and divide is its _rn intrinsic,
// and the build uses -fmad=false and no fast math (accurate expf, IEEE
// division).  NaN inputs are not handled.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(), which the ctypes wrapper turns into an exception.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define NEG_MASK (-1e30f)
#define NO_INDEX 0x7fffffff
#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_REG_EXPERTS 256
// The four-lanes-per-row path from this many rows on: 16,384 rows are 512
// warps of the warp-per-row path, about 4 per SM, whose sort (about 300
// instructions and 49 shuffles a row) then bounds the time.
#define ROWS_MIN_T 16384
#define ROWS_THREADS 128
#define ROWS_BLOCKS_PER_SM 16
#define WARP_BLOCKS_PER_SM 8
#define ROW_GROUP 4

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_w(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_w(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Gate {
  const float* H;
  const int32_t* steps;
  float cap;
  float scale;  // sigmoid mode: the routed weights' factor
  int backpressure;
  int64_t* idx;
  float* counts;
  float* H_new;
  int32_t* steps_out;
  int32_t* ws;  // [0] ticket, [1 + e] picks of expert e
  int T, E, k;
};

__device__ __forceinline__ float bias_of(const Gate& g, int e) {
  return g.backpressure ? __fdiv_rn(g.H[e], fmaxf(g.cap, 1.0f)) : 0.0f;
}

// The sigmoid mode's score: 1 / (1 + exp(-x)), each step rounded once.
__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// A pick's weight from its prob and the picks' sum (at least 1e-9).
template <bool SIG>
__device__ __forceinline__ float weight(const Gate& g, float p, float wsum) {
  const float w = __fdiv_rn(p, wsum);
  return SIG ? __fmul_rn(w, g.scale) : w;
}

// (v, i) comes before (ov, oi): the larger value, the lower index if equal.
__device__ __forceinline__ bool before(float v, int i, float ov, int oi) {
  return v > ov || (v == ov && i < oi);
}

// One compare-exchange of a bitonic network between this lane and lane ^
// stride; the lane keeps the element that comes first if ``first``.
__device__ __forceinline__ void cmpx(float& v, int& i, int stride,
                                     bool first) {
  const float ov = __shfl_xor_sync(FULL_MASK, v, stride);
  const int oi = __shfl_xor_sync(FULL_MASK, i, stride);
  if (before(ov, oi, v, i) == first) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float warp_max(float m) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
  return m;
}

__device__ __forceinline__ float warp_sum(float acc) {
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(FULL_MASK, acc, o));
  return acc;
}

// counts, H_new and steps + 1 from the finished counts.
__device__ __forceinline__ void write_state(const Gate& g, int e, int c) {
  const float cf = (float)c;
  g.counts[e] = cf;
  g.H_new[e] = fmaxf(__fsub_rn(__fadd_rn(g.H[e], cf), g.cap), 0.0f);
}

// The end of every block.  A grid of one block (a decode step's gate)
// writes the state from its shared counts and leaves the workspace alone:
// the fence and atomics of the cross-block path cost about 2 us, as much
// as the rest of the launch.  Otherwise every block adds its counts into
// the workspace; the last block writes the state and resets the
// workspace.
__device__ void finish(const Gate& g, int* s_cnt) {
  __shared__ int s_last;
  __syncthreads();
  if (gridDim.x == 1) {
    for (int e = threadIdx.x; e < g.E; e += blockDim.x)
      write_state(g, e, s_cnt[e]);
    if (threadIdx.x == 0) g.steps_out[0] = g.steps[0] + 1;
    return;
  }
  for (int e = threadIdx.x; e < g.E; e += blockDim.x) {
    const int c = s_cnt[e];
    if (c) atomicAdd(&g.ws[1 + e], c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&g.ws[0], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = threadIdx.x; e < g.E; e += blockDim.x)
    write_state(g, e, atomicExch(&g.ws[1 + e], 0));
  if (threadIdx.x == 0) {
    g.steps_out[0] = g.steps[0] + 1;
    atomicExch(&g.ws[0], 0);
  }
}

// E <= 32 R, k <= 32: the row in registers, R entries per lane.
template <typename Tin, int R, bool SIG>
__global__ void __launch_bounds__(THREADS)
    bp_topk_route_regs_kernel(const Tin* __restrict__ logits,
                              Tin* __restrict__ w_out, Gate g) {
  extern __shared__ int s_cnt[];
  for (int e = threadIdx.x; e < g.E; e += blockDim.x) s_cnt[e] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t stride_rows = (int64_t)gridDim.x * warps;
  float bias[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane + 32 * r;
    bias[r] = e < g.E ? bias_of(g, e) : 0.0f;
  }
  int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
  float x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane + 32 * r;
    x[r] = (row < g.T && e < g.E) ? widen(logits[row * g.E + e]) : -INFINITY;
  }
  for (; row < g.T; row += stride_rows) {
    // the next row's logits, in flight while this one is worked on
    const int64_t next = row + stride_rows;
    float xn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = lane + 32 * r;
      xn[r] = (next < g.T && e < g.E) ? widen(logits[next * g.E + e])
                                      : -INFINITY;
    }
    float p[R];
    if constexpr (SIG) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        p[r] = (lane + 32 * r < g.E) ? sigmoid_rn(x[r]) : 0.0f;
    } else {
      // softmax: exact max; the sum in ref.warp_sum's order
      float m = x[0];
#pragma unroll
      for (int r = 1; r < R; ++r) m = fmaxf(m, x[r]);
      m = warp_max(m);
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p[r] = (lane + 32 * r < g.E) ? expf(__fsub_rn(x[r], m)) : 0.0f;
        acc = __fadd_rn(acc, p[r]);
      }
      acc = warp_sum(acc);
#pragma unroll
      for (int r = 0; r < R; ++r) p[r] = __fdiv_rn(p[r], acc);
    }
    float v[R];
    int i[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = lane + 32 * r;
      v[r] = e < g.E ? __fsub_rn(p[r], bias[r]) : -INFINITY;
      i[r] = e;
    }
    // sort every column across the warp: the first element to lane 0
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int st = size >> 1; st > 0; st >>= 1) {
        const bool first = ((lane & st) == 0) == ((lane & size) == 0);
#pragma unroll
        for (int r = 0; r < R; ++r) cmpx(v[r], i[r], st, first);
      }
    }
    // fold the columns into the running top 32
    float bv = v[0];
    int bi = i[0];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float cv = __shfl_xor_sync(FULL_MASK, v[r], 31);
      const int ci = __shfl_xor_sync(FULL_MASK, i[r], 31);
      if (before(cv, ci, bv, bi)) {
        bv = cv;
        bi = ci;
      }
#pragma unroll
      for (int st = 16; st > 0; st >>= 1)
        cmpx(bv, bi, st, (lane & st) == 0);
    }
    // lane j < k holds pick j: its prob from the owner lane's registers
    float pj = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float t = __shfl_sync(FULL_MASK, p[r], bi & 31);
      if ((bi >> 5) == r) pj = t;
    }
    float wsum = 0.0f;
    for (int j = 0; j < g.k; ++j)
      wsum = __fadd_rn(wsum, __shfl_sync(FULL_MASK, pj, j));
    wsum = fmaxf(wsum, 1e-9f);
    if (lane < g.k) {
      g.idx[row * g.k + lane] = bi;
      store_w(&w_out[row * g.k + lane], weight<SIG>(g, pj, wsum));
      atomicAdd(&s_cnt[bi], 1);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = xn[r];
  }
  finish(g, s_cnt);
}

// Any E and k: the row's probs and sel in shared memory, k argmax passes.
template <typename Tin, bool SIG>
__global__ void __launch_bounds__(THREADS)
    bp_topk_route_smem_kernel(const Tin* __restrict__ logits,
                              Tin* __restrict__ w_out, Gate g) {
  extern __shared__ int smem[];
  int* s_cnt = smem;
  for (int e = threadIdx.x; e < g.E; e += blockDim.x) s_cnt[e] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* s_p = reinterpret_cast<float*>(smem + g.E) +
               (int64_t)warp * (2 * g.E + g.k);
  float* s_sel = s_p + g.E;
  float* s_pick = s_sel + g.E;
  for (int64_t row = (int64_t)blockIdx.x * warps + warp; row < g.T;
       row += (int64_t)gridDim.x * warps) {
    const Tin* s = logits + row * g.E;
    if constexpr (SIG) {
      for (int e = lane; e < g.E; e += 32) {
        const float p = sigmoid_rn(widen(s[e]));
        s_p[e] = p;
        s_sel[e] = __fsub_rn(p, bias_of(g, e));
      }
    } else {
      float m = -INFINITY;
      for (int e = lane; e < g.E; e += 32) m = fmaxf(m, widen(s[e]));
      m = warp_max(m);
      float acc = 0.0f;
      for (int e = lane; e < g.E; e += 32) {
        const float x = expf(__fsub_rn(widen(s[e]), m));
        s_p[e] = x;
        acc = __fadd_rn(acc, x);
      }
      acc = warp_sum(acc);
      for (int e = lane; e < g.E; e += 32) {
        const float p = __fdiv_rn(s_p[e], acc);
        s_p[e] = p;
        s_sel[e] = __fsub_rn(p, bias_of(g, e));
      }
    }
    __syncwarp();
    float wsum = 0.0f;
    for (int j = 0; j < g.k; ++j) {
      float bv = -INFINITY;
      int bi = NO_INDEX;
      for (int e = lane; e < g.E; e += 32) {
        const float v = s_sel[e];
        if (v > bv || bi == NO_INDEX) {  // own entries rise with e
          bv = v;
          bi = e;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
        const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      const float p = s_p[bi];
      wsum = __fadd_rn(wsum, p);
      if (lane == 0) {
        g.idx[row * g.k + j] = bi;
        s_pick[j] = p;
        atomicAdd(&s_cnt[bi], 1);
      }
      if (lane == (bi & 31)) s_sel[bi] = NEG_MASK;
      __syncwarp();
    }
    wsum = fmaxf(wsum, 1e-9f);
    for (int j = lane; j < g.k; j += 32)
      store_w(&w_out[row * g.k + j], weight<SIG>(g, s_pick[j], wsum));
    __syncwarp();
  }
  finish(g, s_cnt);
}

// One level of ref.warp_sum's halving, s[l] += s[l + H] for l < H, with
// constant indices so that s stays in registers.
template <int H>
__device__ __forceinline__ void halve(float* s) {
#pragma unroll
  for (int l = 0; l < H; ++l) s[l] = __fadd_rn(s[l], s[l + H]);
}

// Many rows of exactly E_ = 32 or 64 experts (a prefill's gate): a group
// of G = 4 lanes per row, lane q of the group holding the entries
// e = q, q + 4, q + 8, ... in registers.  ref.warp_sum's lane partial l
// (entries l, l + 32, ...) then lives on lane l % 4, so its halving
// levels 16, 8 and 4 are local and 2 and 1 are shuffles.  Pick j is the
// first entry, in the order (sel descending, index ascending), after pick
// j - 1: each lane folds its own entries in rising order, then two
// (value, index) butterfly steps.  No masking; every lane of the group
// keeps the picks' serial sum, and the probs wait in shared memory
// ([k][threads], conflict-free) for the division.  A warp's eight rows
// move together, so the shuffles never diverge at the ragged end.
template <int G>
__device__ __forceinline__ void group_best(float& bv, int& bi, float& bp) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
    const float op = __shfl_xor_sync(FULL_MASK, bp, o);
    if (before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
      bp = op;
    }
  }
}

template <typename Tin, int E_, bool SIG>
__global__ void __launch_bounds__(ROWS_THREADS)
    bp_topk_route_rows_kernel(const Tin* __restrict__ logits,
                              Tin* __restrict__ w_out, Gate g) {
  constexpr int G = ROW_GROUP;
  constexpr int N = E_ / G;          // entries per lane
  constexpr int P = 32 / G;          // ref.warp_sum partials per lane
  extern __shared__ int smem[];
  int* s_cnt = smem;
  float* s_bias = reinterpret_cast<float*>(smem + E_);
  float* s_pick = s_bias + E_;
  for (int e = threadIdx.x; e < E_; e += blockDim.x) {
    s_cnt[e] = 0;
    s_bias[e] = bias_of(g, e);
  }
  __syncthreads();
  const int q = threadIdx.x % G;
  const int rows_per_block = blockDim.x / G;
  for (int64_t r0 = (int64_t)blockIdx.x * rows_per_block; r0 < g.T;
       r0 += (int64_t)gridDim.x * rows_per_block) {
    const int64_t row = r0 + threadIdx.x / G;
    const bool live = row < g.T;
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] = live ? widen(logits[row * E_ + q + G * j]) : 0.0f;
    if constexpr (SIG) {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = sigmoid_rn(v[j]);
    } else {
      float m = v[0];
#pragma unroll
      for (int j = 1; j < N; ++j) m = fmaxf(m, v[j]);
#pragma unroll
      for (int o = 1; o < G; o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = expf(__fsub_rn(v[j], m));
      // lane partial l = q + G t: entries l + 32 r, i.e. v[t + P r]
      float s[P];
#pragma unroll
      for (int t = 0; t < P; ++t) {
        float a = 0.0f;
#pragma unroll
        for (int r = 0; r < E_ / 32; ++r) a = __fadd_rn(a, v[t + P * r]);
        s[t] = a;
      }
      halve<P / 2>(s);               // levels 16, 8, 4: l and l + h local
      halve<P / 4>(s);
      halve<P / 8>(s);
      float acc = s[0];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)  // levels 2, 1: across the group
        acc = __fadd_rn(acc, __shfl_xor_sync(FULL_MASK, acc, o));
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = __fdiv_rn(v[j], acc);
    }
    float sel[N];
#pragma unroll
    for (int j = 0; j < N; ++j) sel[j] = __fsub_rn(v[j], s_bias[q + G * j]);
    float pv = INFINITY, wsum = 0.0f;
    int pi = -1;
    for (int j = 0; j < g.k; ++j) {
      float bv = -INFINITY, bp = 0.0f;
      int bi = NO_INDEX;
#pragma unroll
      for (int t = 0; t < N; ++t) {
        const int e = q + G * t;
        const bool after = sel[t] < pv || (sel[t] == pv && e > pi);
        if (after && (bi == NO_INDEX || sel[t] > bv)) {
          bv = sel[t];
          bi = e;
          bp = v[t];
        }
      }
      group_best<G>(bv, bi, bp);
      pv = bv;
      pi = bi;
      wsum = __fadd_rn(wsum, bp);
      if (live && q == j % G) {
        g.idx[row * g.k + j] = bi;
        s_pick[j * blockDim.x + threadIdx.x] = bp;
        atomicAdd(&s_cnt[bi], 1);
      }
    }
    wsum = fmaxf(wsum, 1e-9f);
    if (live)
      for (int j = q; j < g.k; j += G)
        store_w(&w_out[row * g.k + j],
                weight<SIG>(g, s_pick[j * blockDim.x + threadIdx.x], wsum));
  }
  finish(g, s_cnt);
}

template <typename Tin, bool SIG>
static int launch(const void* logits, void* w, Gate g, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms < 1) sms = 1;
  const Tin* in = (const Tin*)logits;
  Tin* out = (Tin*)w;
  if (g.T >= ROWS_MIN_T && (g.E == 32 || g.E == 64)) {
    const int rows_per_block = ROWS_THREADS / ROW_GROUP;
    int64_t blocks = (g.T + rows_per_block - 1) / rows_per_block;
    if (blocks > (int64_t)sms * ROWS_BLOCKS_PER_SM)
      blocks = (int64_t)sms * ROWS_BLOCKS_PER_SM;
    const size_t smem = (size_t)g.E * 8 + (size_t)g.k * ROWS_THREADS * 4;
    if (g.E == 32)
      bp_topk_route_rows_kernel<Tin, 32, SIG>
          <<<(unsigned)blocks, ROWS_THREADS, smem, stream>>>(in, out, g);
    else
      bp_topk_route_rows_kernel<Tin, 64, SIG>
          <<<(unsigned)blocks, ROWS_THREADS, smem, stream>>>(in, out, g);
    return (int)cudaGetLastError();
  }
  if (g.E <= MAX_REG_EXPERTS && g.k <= 32) {
    const int warps = g.T < WARPS ? g.T : WARPS;
    int64_t blocks = (g.T + warps - 1) / warps;
    if (blocks > (int64_t)sms * WARP_BLOCKS_PER_SM)
      blocks = (int64_t)sms * WARP_BLOCKS_PER_SM;
    const size_t smem = (size_t)g.E * sizeof(int);
    const dim3 grid((unsigned)blocks), block(warps * 32);
    if (g.E <= 32)
      bp_topk_route_regs_kernel<Tin, 1, SIG>
          <<<grid, block, smem, stream>>>(in, out, g);
    else if (g.E <= 64)
      bp_topk_route_regs_kernel<Tin, 2, SIG>
          <<<grid, block, smem, stream>>>(in, out, g);
    else if (g.E <= 128)
      bp_topk_route_regs_kernel<Tin, 4, SIG>
          <<<grid, block, smem, stream>>>(in, out, g);
    else
      bp_topk_route_regs_kernel<Tin, 8, SIG>
          <<<grid, block, smem, stream>>>(in, out, g);
    return (int)cudaGetLastError();
  }
  // shared-memory path: fewer warps per block when a row's buffers are large
  int warps = WARPS;
  auto bytes = [&](int nw) {
    return (size_t)g.E * sizeof(int) + (size_t)nw * (2 * g.E + g.k) * 4;
  };
  while (warps > 1 && bytes(warps) > 48 * 1024) warps >>= 1;
  const size_t smem = bytes(warps);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bp_topk_route_smem_kernel<Tin, SIG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int64_t blocks = (g.T + warps - 1) / warps;
  if (blocks > (int64_t)sms * 8) blocks = (int64_t)sms * 8;
  bp_topk_route_smem_kernel<Tin, SIG><<<(unsigned)blocks, warps * 32, smem,
                                        stream>>>(in, out, g);
  return (int)cudaGetLastError();
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (logits and w).  score: 0 = softmax,
// 1 = sigmoid, whose weights are multiplied by `scale`.  ws: int32 [1 + E],
// zero before the first launch; every launch leaves it zero.
int bp_topk_route(const void* logits, int dtype, const void* H,
                  const void* steps, float cap, int backpressure, int score,
                  float scale, void* idx, void* w, void* counts, void* H_new,
                  void* steps_out, void* ws, int T, int E, int k,
                  void* stream) {
  if (T < 1 || E < 1 || k < 1 || k > E || score < 0 || score > 1)
    return (int)cudaErrorInvalidValue;
  Gate g;
  g.H = (const float*)H;
  g.steps = (const int32_t*)steps;
  g.cap = cap;
  g.scale = scale;
  g.backpressure = backpressure;
  g.idx = (int64_t*)idx;
  g.counts = (float*)counts;
  g.H_new = (float*)H_new;
  g.steps_out = (int32_t*)steps_out;
  g.ws = (int32_t*)ws;
  g.T = T;
  g.E = E;
  g.k = k;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return score ? launch<float, true>(logits, w, g, s)
                 : launch<float, false>(logits, w, g, s);
  if (dtype == 1)
    return score ? launch<__nv_bfloat16, true>(logits, w, g, s)
                 : launch<__nv_bfloat16, false>(logits, w, g, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
